"""The HTML pages of rendered videos (the port's copy of
``mixstage_tpu/htmlgrid``)."""

from mixstage_tpu_torch.htmlgrid.to_html import (get_list_files,  # noqa: F401
                                                 make_html_file)
