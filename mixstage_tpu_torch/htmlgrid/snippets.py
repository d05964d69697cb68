"""Composable HTML snippets: grids, headings and descriptions.

The port's copy of ``mixstage_tpu/htmlgrid/snippets.py``, after the
reference's templates (chahuja/mix-stage ``src/htmlUtils/app/templates/``
{grid,index,description,heading}.html and ``toHTML.py::get_html_snippet``
:45-53, ``makeHTMLfile`` :56-76).  One ``grid.html`` snippet per sample
index, composed in memory through ``index.html``: an ``mp4`` cell embeds a
video, a ``gif`` an image, an ``avi`` a download link, and the literal
``'0'`` / ``'1'`` marker cells become the "Content \\ Style" / "Speaker \\
Model" corner headers.  ``make_supplementary`` builds an appendix page:
a heading, then per section a description and a grid.
"""

from __future__ import annotations

import os
from ast import literal_eval
from pathlib import Path
from typing import Dict, List, Optional, Sequence

from jinja2 import Template

_STYLE = """<style>
table {
  font-family: arial, sans-serif;
  width: 100%;
  margin-left: auto;
  margin-right: auto;
}

table, th, td {
  border: 1px solid black;
}
</style>"""

# the four reference template vocabularies (templates/{grid,index,
# description,heading}.html), re-expressed
TEMPLATES: Dict[str, Template] = {
    "heading.html": Template('<h1 align="center">{{ h1 }}</h1>'),
    "description.html": Template(
        "<h1><u>{{ h1 }}</u></h1>\n<h3>{{ h2 }}</h3>"),
    "grid.html": Template(
        "{% if h1 is defined %}<h1><u>{{ h1 }}</u></h1>\n{% endif %}"
        "{% if h2 is defined %}<h3>{{ h2 }}</h3>\n{% endif %}"
        "<table>\n  <tbody>\n"
        "  {% for name in names %}"
        "  <tr>\n"
        "    {% for col in columns %}"
        "{% if name[col].endswith('.gif') %}"
        '    <td align="center"><img width="300" '
        'src="{{ name[col] }}"></td>\n'
        "{% elif name[col].endswith('.mp4') %}"
        '    <td align="center"><video width="300" controls>'
        '<source src="{{ name[col] }}" type="video/mp4">'
        "</video></td>\n"
        "{% elif name[col].endswith('.avi') %}"
        '    <td align="center"><a href="{{ name[col] }}" download>'
        "AVI clip with audio (download)</a></td>\n"
        "{% elif name[col] == '0' %}"
        '    <td align="center"> <b>Content \\ Style</b> </td>\n'
        "{% elif name[col] == '1' %}"
        '    <td align="center"> <h2>Speaker \\ Model</h2> </td>\n'
        "{% else %}"
        '    <td align="center"> {{ name[col] }} </td>\n'
        "{% endif %}"
        "{% endfor %}"
        "  </tr>\n"
        "  {% endfor %}"
        "  </tbody>\n</table>\n<hr>"),
    "index.html": Template(
        "<body>\n<head>\n" + _STYLE + "\n</head>\n\n"
        "{% for body in bodies %}{{ body }}\n{% endfor %}\n</body>"),
}


def get_html_snippet(template_file: str, kwargs_dict: Dict) -> str:
    """Render one named snippet (reference get_html_snippet, toHTML.py:45-53
    — which wrote to a temp file under app/; we return the string)."""
    return TEMPLATES[template_file].render(**kwargs_dict)


def compose_index(bodies: Sequence[str]) -> str:
    """Compose rendered snippets into a full page (reference index.html's
    ``{% include name %}`` loop over temp snippet files)."""
    return TEMPLATES["index.html"].render(bodies=list(bodies))


def get_list_files(path2videos: str, idx: int) -> List[List[str]]:
    """The reference's content×style matrix for sample ``idx``
    (toHTML.py:17-43): row/column speakers parsed from the bracketed
    speaker list in the experiment dir name; diagonal reads ``render/``,
    off-diagonal ``render_<src>_<tgt>/``; each cell is the idx-th video of
    ``<dir>/test/<src>`` (falling back to the first)."""
    speakers = literal_eval(
        "[" + path2videos.split("[")[-1].split("]")[0] + "]")
    list_files: List[List[str]] = [["0"] + speakers]
    for sp1 in speakers:
        row = [sp1]
        for sp2 in speakers:
            directory = "render" if sp1 == sp2 \
                else "_".join(["render", sp1, sp2])
            vid_parent = Path(path2videos) / directory / "test" / sp1
            try:
                files = sorted(os.listdir(vid_parent))
            except OSError:
                files = ["None"]
            file = files[idx] if idx < len(files) else files[0]
            row.append((Path(directory) / "test" / sp1 / file).as_posix())
        list_files.append(row)
    return list_files


def make_html_report(path2videos: str, idxs: int = 20,
                     outfile: str = "videos") -> str:
    """Reference ``makeHTMLfile`` (toHTML.py:56-76): one grid snippet per
    sample index (the first carries the experiment path as its title),
    composed via the index template and written as ``<outfile>.html``
    inside the experiment dir."""
    bodies = []
    for idx in range(idxs):
        kwargs = {"h2": str(idx), "names": get_list_files(path2videos, idx),
                  "columns": list(range(len(get_list_files(path2videos,
                                                           idx)[0])))}
        if idx == 0:
            kwargs["h1"] = str(path2videos)
        bodies.append(get_html_snippet("grid.html", kwargs))
    dest = Path(path2videos) / f"{outfile}.html"
    dest.write_text(compose_index(bodies))
    return dest.as_posix()


def make_supplementary(sections: Sequence[Dict], title: str,
                       out_path: str) -> str:
    """Build an appendix-style page (reference app/videos.html structure:
    centered heading, then per-section description + video grid).  Each
    section dict: {"title", "description", "names", "columns"}."""
    bodies = [get_html_snippet("heading.html", {"h1": title})]
    for sec in sections:
        bodies.append(get_html_snippet(
            "description.html",
            {"h1": sec["title"], "h2": sec.get("description", "")}))
        if sec.get("names"):
            bodies.append(get_html_snippet(
                "grid.html", {"names": sec["names"],
                              "columns": sec["columns"]}))
    out = Path(out_path)
    out.write_text(compose_index(bodies))
    return out.as_posix()
