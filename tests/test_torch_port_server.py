"""CPU round trip through the port's HTTP front door
(mixstage_tpu_torch/serving): JSON and npz ``/v1/pose``, pow-2 bucketing of
a 100-frame request to 128 frames and back, ``/healthz``, ``/stats``, a bad
style (400), unknown and unconfigured endpoints (404); a streaming session
over HTTP against ``StreamingSession`` over the direct serving function,
its finish, close and errors; ``/v1/pose_from_waveform`` on a 64-mel
generator against the direct waveform serving function."""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from mixstage_tpu_torch.models import JointLateClusterSoftStyle4_G
from mixstage_tpu_torch.models.layers import reset_parameters_
from mixstage_tpu_torch.ops.bucketing import next_pow2, pow2_pad
from mixstage_tpu_torch.serve import (build_serving_fn,
                                      build_waveform_serving_fn)
from mixstage_tpu_torch.serving import (DynamicBatcher, PoseClient,
                                        PoseService, start_http_server)
from mixstage_tpu_torch.streaming import session_over_serving_fn

MEL = 32


@pytest.fixture(scope="module")
def served():
    torch.set_num_threads(2)
    model = JointLateClusterSoftStyle4_G(num_clusters=2, num_speakers=2,
                                         in_channels=64)
    reset_parameters_(model, torch.Generator().manual_seed(0),
                      random_bn_stats=True)
    fn = build_serving_fn(model, device="cpu")
    batcher = DynamicBatcher(fn, batch_size=4, max_wait_ms=20.0)
    service = PoseService(batcher, backend=fn.device.type, num_styles=2,
                          mel_bins=MEL)
    server = start_http_server(service, port=0)
    try:
        yield fn, PoseClient(f"http://127.0.0.1:{server.server_address[1]}")
    finally:
        server.shutdown()
        server.server_close()
        batcher.close()


def test_pose_requests_round_trip(served):
    fn, client = served
    rng = np.random.default_rng(0)
    a64 = rng.normal(size=(64, MEL)).astype(np.float32)
    a100 = rng.normal(size=(100, MEL)).astype(np.float32)

    pose_json = client.pose_json(a64, style=1)
    want = fn(a64[None], np.eye(2, dtype=np.float32)[[1]])[0].numpy()
    np.testing.assert_allclose(pose_json, want, rtol=1e-5, atol=1e-5)

    mix = np.array([0.3, 0.7], np.float32)
    pose_npz = client.pose(a64, style=mix)
    np.testing.assert_allclose(pose_npz, fn(a64[None], mix[None])[0].numpy(),
                               rtol=1e-5, atol=1e-5)

    pose_long = client.pose(a100, style=0)      # 100 frames → 128 bucket
    padded, true_len = pow2_pad(a100, floor=64)
    assert padded.shape[0] == 128 and true_len == 100
    want = fn(padded[None], np.eye(2, dtype=np.float32)[[0]])[0].numpy()
    assert pose_long.shape == (100, 96)
    np.testing.assert_allclose(pose_long, want[:100], rtol=1e-5, atol=1e-5)

    assert client.health() == {"ok": True, "backend": "cpu", "batch_size": 4}
    stats = client.stats()
    assert stats["requests"] == 3 and stats["shed"] == 0


def test_bad_requests_and_later_endpoints(served):
    _, client = served
    a64 = np.zeros((64, MEL), np.float32)
    with pytest.raises(urllib.error.HTTPError) as err:
        client.pose(a64, style=5)
    assert err.value.code == 400
    assert "out of range" in json.loads(err.value.read())["error"]
    with pytest.raises(urllib.error.HTTPError) as err:
        client.pose(np.zeros((64, MEL + 1), np.float32))
    assert err.value.code == 400
    # no waveform batcher on this server; an unknown session; no such path
    body = json.dumps({"audio": [0.0] * 100}).encode()
    for path in ("/v1/pose_from_waveform", "/v1/stream/nosuchsession",
                 "/v1/stream/nosuchsession/finish", "/v1/other"):
        req = urllib.request.Request(client.base_url + path, data=body,
                                     headers={"Content-Type":
                                              "application/json"})
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req, timeout=10)
        assert err.value.code == 404, path


def test_stream_routes(served):
    """A session fed in uneven chunks over HTTP returns what
    ``StreamingSession`` over the direct serving function returns (the
    batcher pads to its batch size: float rounding only)."""
    fn, client = served
    x = np.random.default_rng(4).normal(size=(150, MEL)).astype(np.float32)
    stream = client.stream(style=1, hop=32)
    assert (stream.window, stream.hop) == (64, 32)
    pieces = [stream.feed(x[i:i + 50]) for i in range(0, 150, 50)]
    assert client.stats()["streams"] == 1
    pieces.append(stream.finish())
    got = np.concatenate([p for p in pieces if p.size])
    sess = session_over_serving_fn(fn, np.eye(2, dtype=np.float32)[1],
                                   hop=32)
    want = np.concatenate([p for p in (sess.feed(x), sess.finish())
                           if p.size])
    assert got.shape == (150, 96)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert client.stats()["streams"] == 0
    with pytest.raises(urllib.error.HTTPError) as err:
        stream.feed(x[:10])                     # finished: gone
    assert err.value.code == 404
    other = client.stream(style=0)
    with pytest.raises(urllib.error.HTTPError) as err:
        other.feed(np.zeros((4, MEL + 1), np.float32))
    assert err.value.code == 400
    for closed in (True, False):                 # DELETE drops it once
        req = urllib.request.Request(
            f"{client.base_url}/v1/stream/{other.session}", method="DELETE")
        with urllib.request.urlopen(req, timeout=10) as resp:
            assert json.loads(resp.read()) == {"closed": closed}


def test_waveform_route():
    torch.set_num_threads(2)
    model = JointLateClusterSoftStyle4_G(num_clusters=2, num_speakers=2,
                                         in_channels=64)
    reset_parameters_(model, torch.Generator().manual_seed(1),
                      random_bn_stats=True)
    wave_fn = build_waveform_serving_fn(model, device="cpu")
    mel_fn = build_serving_fn(model, device="cpu")
    batcher = DynamicBatcher(mel_fn, batch_size=2, max_wait_ms=5.0)
    wave_batcher = DynamicBatcher(wave_fn, batch_size=2, max_wait_ms=5.0)
    service = PoseService(batcher, backend="cpu", num_styles=2, mel_bins=64,
                          waveform_batcher=wave_batcher)
    server = start_http_server(service, port=0)
    try:
        client = PoseClient(f"http://127.0.0.1:{server.server_address[1]}")
        wav = np.random.default_rng(5).normal(size=wave_fn.n_samples) \
            .astype(np.float32)
        pose = client.pose_from_waveform(wav, style=1)
        want = wave_fn(wav[None], np.eye(2, dtype=np.float32)[[1]])[0]
        assert pose.shape == (64, 96)
        np.testing.assert_allclose(pose, want.numpy(), rtol=1e-5, atol=1e-5)
        with pytest.raises(urllib.error.HTTPError) as err:
            client.pose_from_waveform(wav[:1000])   # too short
        assert err.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as err:
            client.pose_from_waveform(np.zeros((2, 8), np.float32))
        assert err.value.code == 400
    finally:
        server.shutdown()
        server.server_close()
        batcher.close()
        wave_batcher.close()


def test_bucketing_helpers():
    assert [next_pow2(n, 64) for n in (1, 64, 65, 100, 4096)] == \
        [64, 64, 128, 128, 4096]
    arr = np.arange(6, dtype=np.float32).reshape(3, 2)
    padded, true_len = pow2_pad(arr, floor=4)
    assert true_len == 3 and np.array_equal(padded[3], arr[2])
    same, none = pow2_pad(arr[:2], floor=2)
    assert none is None and np.array_equal(same, arr[:2])
    with pytest.raises(ValueError):
        next_pow2(0)
