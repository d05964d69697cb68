"""The style-transfer video matrix page (``videos.html``).

The port's copy of ``mixstage_tpu/htmlgrid/to_html.py``, after the
reference's ``toHTML.py`` (chahuja/mix-stage ``src/htmlUtils``):
``get_list_files`` (:17-43) scans the speaker × style grid of
``render_<src>_<tgt>`` directories and ``make_html_file`` (:56-76) writes
the page with jinja2.

  python -m mixstage_tpu_torch.htmlgrid.to_html -load <PREFIX_weights.p>
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, List

from jinja2 import Template

_TEMPLATE = Template("""<!DOCTYPE html>
<html>
<head>
  <title>{{ title }}</title>
  <style>
    body { font-family: monospace; }
    table { border-collapse: collapse; }
    td, th { border: 1px solid #999; padding: 4px; text-align: center; }
    video, img { max-width: 320px; }
  </style>
</head>
<body>
  <h1>{{ title }}</h1>
  <table>
    <tr><th>source \\ target</th>
    {% for tgt in targets %}<th>{{ tgt }}</th>{% endfor %}</tr>
    {% for src in sources %}
    <tr><th>{{ src }}</th>
      {% for tgt in targets %}
      <td>
        {% for video in grid.get((src, tgt), []) %}
        <div>{{ video.rsplit('/', 1)[-1] }}</div>
        {% if video.endswith('.gif') %}
        <img src="{{ video }}" alt="{{ video }}">
        {% elif video.endswith('.avi') %}
        {# browsers cannot demux MJPEG AVI — link instead of a dead player #}
        <div><a href="{{ video }}" download>AVI clip with audio (download)</a></div>
        {% else %}
        <video controls src="{{ video }}"></video>
        {% endif %}
        {% endfor %}
      </td>
      {% endfor %}
    </tr>
    {% endfor %}
  </table>
</body>
</html>
""")


def get_list_files(view_dir: str, num_videos: int = 2) -> Dict:
    """Scan render_<src>_<tgt> dirs into a (src, tgt) → [video paths] grid."""
    view = Path(view_dir)
    grid: Dict = {}
    speakers = set()
    for entry in sorted(view.iterdir()) if view.exists() else []:
        if not entry.is_dir() or not entry.name.startswith("render"):
            continue
        parts = entry.name.split("_")
        if len(parts) >= 3:
            src, tgt = parts[1], "_".join(parts[2:])
        elif len(parts) == 2:
            src = tgt = parts[1]
        else:
            src = tgt = "same"
        speakers.update([src, tgt])
        videos = sorted(str(p.relative_to(view))
                        for p in entry.rglob("*")
                        if p.suffix in (".mp4", ".gif", ".avi"))[:num_videos]
        grid[(src, tgt)] = videos
    return {"grid": grid, "speakers": sorted(speakers)}


def make_html_file(view_dir: str, num_videos: int = 2,
                   outfile: str = "videos",
                   title: str = "Mix-StAGE style transfer") -> str:
    """Write ``<outfile>.html`` with up to ``num_videos`` clips per style
    pair (reference makeHTMLfile(dir_name, idxs, outfile), toHTML.py:56-76;
    the render CLI builds both 'videos' and a 4-clip 'videos_subset',
    render.py:131-132)."""
    info = get_list_files(view_dir, num_videos or 2)
    html = _TEMPLATE.render(title=f"{title} ({outfile})", grid=info["grid"],
                            sources=info["speakers"],
                            targets=info["speakers"])
    out = Path(view_dir) / f"{outfile}.html"
    os.makedirs(view_dir, exist_ok=True)
    out.write_text(html)
    return out.as_posix()


# reference-spelled alias
makeHTMLfile = make_html_file


def make_html_file_loop(args, exp_num: int):
    """Standalone CLI loop: rebuild the video-matrix pages of a checkpointed
    experiment (reference ``makeHTMLfile_loop``, toHTML.py:78-93 +
    ``argparseNloop`` main)."""
    assert args.load, "pass -load <PREFIX_weights.p>"
    assert os.path.exists(args.load) or os.path.exists(
        args.load.replace("_weights.p", "_args.args")), \
        f"load file {args.load} must exist"
    from mixstage_tpu_torch.bookkeeping import BookKeeper
    from mixstage_tpu_torch.config import get_args_update_dict

    book = BookKeeper(args, ["exp", "cpk", "speaker", "model"],
                      args_dict_update=get_args_update_dict(args))
    dir_name = book.name.dir(book.args.save_dir)
    make_html_file(dir_name, book.args.render, "videos")
    make_html_file(dir_name, 4, "videos_subset")


def main(argv=None):
    from mixstage_tpu_torch.config import argparse_n_loop

    argparse_n_loop(make_html_file_loop, argv)


if __name__ == "__main__":
    main()
