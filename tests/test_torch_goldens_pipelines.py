"""The port's sweep, regional and sequence runs on the golden corpus.

For the ``sweep_frame``, ``regional`` and ``sequence_frame`` modes of
``tests/goldens_lib.py`` (Adam, 3 steps, taps [0, 5]/[2], content init,
seeded weights, 64x64), the port's pipeline runs on
``goldens_lib.write_inputs`` with ``goldens_lib``'s configuration, and
so does the JAX package's runner. Gates:

- the committed ``tests/goldens/<mode>.png`` at SSIM >= 0.98 and MAD <=
  2.0 (``goldens_lib``'s bounds), for the port's run as it is;
- the JAX run's PNG within 2 uint8 levels. The sweep's and the
  sequence's golden frame is warm-started: there the JAX run's frames
  start from the port's start images (``tests/torch_pipelines.
  trace_frames`` says why; run free, the JAX package's second sequence
  frame parts from the port's by up to 6 levels at 5 of its 12,288
  values);
- each frame's per-step loss curve within 1e-3 relative of the JAX
  run's.
"""
from __future__ import annotations

import pytest

from style_transfer_visualizer_tpu import blend_sweep as jax_sweep
from style_transfer_visualizer_tpu import sequence as jax_seq
from style_transfer_visualizer_tpu_torch import blend_sweep, regional, sequence
from tests import goldens_lib
from tests.torch_pipelines import (
    assert_curves,
    assert_pngs_close,
    port_config,
    trace_frames,
)


def _sweep(inputs, out):
    return blend_sweep.stylize_blend_sweep(
        inputs.content, [inputs.style1, inputs.style2], port_config(out),
        n_frames=2, sweep_steps=2,
    ).frame_paths[-1]


def _regional(inputs, out):
    return regional.stylize_regional(
        inputs.content, [inputs.style1, inputs.style2],
        [inputs.mask1, inputs.mask2], port_config(out),
    ).output_path


def _sequence(inputs, out):
    return sequence.stylize_sequence(
        inputs.frames_dir, inputs.style1, port_config(out), out,
    ).frame_paths[-1]


#: mode -> (port runner, traced port module, traced JAX module)
MODES = {
    "sweep_frame": (_sweep, blend_sweep, jax_sweep),
    "regional": (_regional, None, None),
    "sequence_frame": (_sequence, sequence, jax_seq),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_pipeline_golden_and_jax_parity(
    tmp_path, monkeypatch, mode,
) -> None:
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    monkeypatch.setenv("STV_NO_XLA_CACHE", "1")
    inputs = goldens_lib.write_inputs(tmp_path / "in")
    run, ours_module, ref_module = MODES[mode]
    ours_trace = ref_trace = None
    if ours_module is not None:
        ours_trace = trace_frames(monkeypatch, ours_module)
    ours = run(inputs, tmp_path / "ours")
    if ref_module is not None:
        ref_trace = trace_frames(monkeypatch, ref_module, replay=ours_trace)
    ref = goldens_lib.MODES[mode](inputs, tmp_path / "ref")
    assert ours.name == ref.name
    ssim, mad = goldens_lib.compare(
        ours, goldens_lib.GOLDENS_DIR / f"{mode}.png",
    )
    assert ssim >= goldens_lib.SSIM_MIN
    assert mad <= goldens_lib.MAD_MAX
    assert_pngs_close(ours, ref)
    if ours_trace is not None:
        assert len(ours_trace.curves) == 2  # noqa: PLR2004
        ours_trace.assert_carried()
        assert_curves(ours_trace, ref_trace)
