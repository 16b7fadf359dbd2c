"""Architecture families: what of a configuration depends on its
architecture, one module a family.

A configuration names its family with ``"family"`` (``"vgg"`` where it
names none), and ``port_bench/families/<family>.py`` supplies:

- ``make_weights(config, seed, device)``: the weights the port and the
  reference share, drawn on ``device`` from
  ``generate.weights_seed(seed)``;
- ``port_params(config, weights, device)``: what the port's entries
  take as ``params=``, made from those weights;
- ``objective(config, weights, content, style)``: the plain fp32
  reference's ``(total, style, content)`` callable on the (1, H, W, 3)
  image in the model's normalized space, given the (1, H, W, 3)
  content and style in [0, 1];
- ``launch_counters()``: name to counter (``launched()``, ``reset()``)
  of the port's own kernels, the keys of a traced rank's ``counted``;
- ``step_flops(config, height, width)``: the frozen matrix-math FLOPs
  of one optimizer step of one ``height`` x ``width`` image.

A family is loaded by its path, as a metric's reader is, so a new
architecture is one new file here; a process loads each file once.
"""
from __future__ import annotations

import importlib.util
import re
from pathlib import Path

DIR = Path(__file__).resolve().parent
DEFAULT = "vgg"
FUNCTIONS = (
    "make_weights", "port_params", "objective", "launch_counters",
    "step_flops",
)
_NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
_LOADED: dict[Path, object] = {}


def load(config: dict):
    """The family module ``config`` names; ``LookupError`` where its
    file is missing or lacks one of :data:`FUNCTIONS`."""
    name = config.get("family", DEFAULT)
    path = DIR / f"{name}.py"
    if not isinstance(name, str) or not _NAME.fullmatch(name) or not path.is_file():
        msg = f"no family port_bench/families/{name}.py"
        raise LookupError(msg)
    if path in _LOADED:
        return _LOADED[path]
    spec = importlib.util.spec_from_file_location(f"port_bench_family_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    missing = [f for f in FUNCTIONS if not callable(getattr(module, f, None))]
    if missing:
        msg = f"the family port_bench/families/{name}.py lacks {', '.join(missing)}"
        raise LookupError(msg)
    _LOADED[path] = module
    return module
