"""Standalone HTML trajectory viewer.

Counterpart of `brax_tpu/io/html.py`: embeds the scene/trajectory JSON
(`brax_torch.io.json`) and the WebGL viewer (`brax_torch/viewer/viewer.js`,
a copy of the JAX package's) into one self-contained page with no external
dependency.  For the same inputs the page is the JAX package's, byte for
byte.
"""

import os
from typing import List, Optional

from brax_torch.io import file
from brax_torch.io import json as io_json
from brax_torch.sim.config import Config
from brax_torch.sim.types import Info, QP

VIEWER_JS = os.path.join(os.path.dirname(__file__), "..", "viewer", "viewer.js")

PAGE = """<!DOCTYPE html>
<html>
<head>
  <meta charset="utf-8"/>
  <title>brax_tpu viewer</title>
  <style>
    html, body {{ margin: 0; padding: 0; background: #11131a; }}
    #brax-tpu-viewer {{ width: 100vw; height: 95vh; }}
  </style>
</head>
<body>
  <div id="brax-tpu-viewer"></div>
  <script>const system = {system_json};</script>
  <script>{viewer_js}</script>
</body>
</html>
"""


def page(system_json: str) -> str:
    """The viewer page around a scene/trajectory JSON document."""
    with open(VIEWER_JS) as f:
        viewer_js = f.read()
    return PAGE.format(system_json=system_json, viewer_js=viewer_js)


def render(config: Config, qps: List[QP], info: Optional[List[Info]] = None) -> str:
    """Returns an HTML page that visualizes one env's trajectory."""
    return page(io_json.dumps(config, qps, info))


def save_html(path: str, config: Config, qps: List[QP], info: Optional[List[Info]] = None):
    """Saves a standalone viewer HTML page."""
    with file.File(path, "w") as fout:
        fout.write(render(config, qps, info))
