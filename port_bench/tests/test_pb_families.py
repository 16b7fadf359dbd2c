"""The architecture families (``port_bench/families``).

The VGG family draws, packs and refers exactly as the harness did
before the families existed, and a family of a new architecture is
added, and rehearsed, with new files and new entries only.
"""
from __future__ import annotations

import hashlib
import json

import pytest
import torch

from port_bench import families, generate, harness
from port_bench.tests.rehearse import rehearse
from port_bench.tests.test_pb_data_driven import _copy, _digests

# Taken from the harness at commit 255c553, before the families: the
# weights as ``generate.make_weights`` drew them, the port's parameters
# as ``_Images`` packed them, and the reference's first three losses
# ``(total, style, content)`` as ``check`` followed them (L-BFGS for
# vgg19-lbfgs, Adam for vgg16-adam), on the CPU with one thread at each
# cell's rehearsal sizes. The losses' digits depend on the thread count.
PINNED = {
    ("vgg19-lbfgs.512-timelapse", 2**31 + 7): (
        "e41740fddd9c48e900380140127b8a3e23ca694a5acb55b0dfa489d0ec098e45",
        "f0086e62a11a32e51b3fd473cba1f8ad3352f458552edc8b767f57ed383454c8",
        [
            (145.46580505371094, 0.0014170854119583964, 3.7572696208953857),
            (145.3263702392578, 0.0014157169498503208, 3.754676342010498),
            (61.36235427856445, 0.0006000975845381618, 1.3525962829589844),
        ],
    ),
    ("vgg19-lbfgs.512-timelapse", 3_456_789_013): (
        "53304da4e09d5b8e743e5c764c8cc1dfe7abcd6400ac52c1a7996421076ee092",
        "1538d037b548123724d290a39b712984713e1442cc2b94d797225dd917c7a11e",
        [
            (126.46282196044922, 0.0012413224903866649, 2.330575704574585),
            (126.38055419921875, 0.0012405123561620712, 2.3293118476867676),
            (29.06280517578125, 0.0002854806079994887, 0.5147433280944824),
        ],
    ),
    ("vgg16-adam.720p-final", 2**31 + 7): (
        "23d45d9aca01b6f117cc4db05298c9b995e5f968dbd2acfbd911043559962a2f",
        "829e1d956ec1826433213b1e11b32f7305448bb5b214e62abd7ba4a66abaacf9",
        [
            (148.76744079589844, 0.00144333450589329, 4.4339919090271),
            (93.57318878173828, 0.0009068661602213979, 2.886571168899536),
            (81.63677215576172, 0.0007953615859150887, 2.100616216659546),
        ],
    ),
    ("vgg16-adam.720p-final", 3_456_789_013): (
        "239c81721db7f57e1f4d47338fdac6a0513ba9495de59551a19f8de318d5bea4",
        "704d37d0a8dd69d5bf105edc555148871ba4bb76e0aa768371b656280a0ba99a",
        [
            (121.47036743164062, 0.0011899814708158374, 2.472219705581665),
            (75.85966491699219, 0.0007408879464492202, 1.7708770036697388),
            (50.38029861450195, 0.00049067463260144, 1.3128352165222168),
        ],
    ),
}


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        t = t.detach().cpu().contiguous()
        h.update(f"{tuple(t.shape)} {t.dtype}".encode())
        h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize(("name", "seed"), sorted(PINNED))
def test_vgg_draws_packs_and_refers_as_before(name, seed, one_thread, monkeypatch) -> None:
    weights_digest, params_digest, losses = PINNED[name, seed]
    cell = harness._rehearsal_cell(harness.load_cell(name))
    config, cpu = cell["config"], torch.device("cpu")
    family = families.load(config)

    weights = generate.make_weights(config, seed, cpu)
    assert _digest(t for i in sorted(weights) for t in weights[i]) == weights_digest
    params = family.port_params(config, weights, cpu)
    assert _digest(
        params[i][k] for i in sorted(params) for k in sorted(params[i])
    ) == params_digest

    followed = []
    for attr in ("lbfgs_losses", "adam_losses"):
        real = getattr(harness.ref_optim, attr)

        def keep(*args, _real=real, **kwargs):
            followed.append(_real(*args, **kwargs))
            return followed[-1]

        monkeypatch.setattr(harness.ref_optim, attr, keep)
    records = [{"index": 0, "losses": [losses]}]
    checked = harness.check(cell, seed, records, cpu)
    assert followed == [losses]
    assert set(checked["gaps"].values()) == {0.0}


@pytest.mark.parametrize("name", ["vgg19-lbfgs.512-timelapse", "vgg16-adam.720p-final"])
def test_a_family_file_is_loaded_once(name) -> None:
    """The cell, the images, the check and ``mfu_pct`` share one module."""
    config = harness.load_cell(name)["config"]
    assert families.load(config) is families.load(dict(config))


_MARKER = '''

import sys as _sys


def _marked(name, real):
    def call(*args, **kwargs):
        print(f"family-marker {name}", file=_sys.stderr, flush=True)
        return real(*args, **kwargs)

    return call


for _name in (
    "make_weights", "port_params", "objective", "launch_counters",
    "step_flops",
):
    globals()[_name] = _marked(_name, globals()[_name])
'''


def test_a_new_family_needs_only_new_files(tmp_path) -> None:
    """A family module, a configuration naming it, its traffic, its
    limits and new ``BENCHMARK.json`` entries: the rehearsal runs the
    new family's functions and no file that was there changes."""
    bench_dir = _copy(tmp_path)
    before = _digests(bench_dir)

    (bench_dir / "families" / "vggcopy.py").write_text(
        (bench_dir / "families" / "vgg.py").read_text() + _MARKER,
    )
    config = json.loads((bench_dir / "configs" / "vgg19-lbfgs.json").read_text())
    config["family"] = "vggcopy"
    (bench_dir / "configs" / "vggcopy-lbfgs.json").write_text(json.dumps(config))
    (bench_dir / "traffic" / "64-copy.json").write_text(json.dumps({
        "entry": "single", "content": [64, 64], "styles": [[64, 64]],
        "steps": 4, "frames": True, "save_every": 2, "log_every": 2,
        "coarse_steps": 0, "warmup_steps": 2,
        "image": {"content_cells": 16, "style_cells": 4, "noise": 0.05},
        "rehearsal": {},
    }))
    name = "vggcopy-lbfgs.64-copy"
    (bench_dir / "limits" / f"{name}.json").write_text(
        (bench_dir / "limits" / "vgg19-lbfgs.512-timelapse.json").read_text(),
    )
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "vggcopy-lbfgs", "source": "https://arxiv.org/abs/1409.1556",
        "file": "port_bench/configs/vggcopy-lbfgs.json", "reduced": [],
        "why": "a throwaway",
    })
    bench["workloads"].append({
        "name": name, "config": "vggcopy-lbfgs", "traffic": "64-copy",
        "chips": 1, "why": "a throwaway",
    })
    for metric in bench["end_to_end"] + bench["per_layer"]:
        if metric["name"] in {"step_ms", "mfu_pct.single"}:
            metric["workloads"].append(name)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    code, line, err = rehearse(name, "--trace", "1", root=tmp_path)
    assert code == 0, err[-3000:]
    assert line["rehearsal"] is True
    assert line["correct"] is True, line["checks"]
    called = {ln.split()[1] for ln in err.splitlines() if ln.startswith("family-marker ")}
    assert called >= {"make_weights", "port_params", "objective", "launch_counters"}
    after = _digests(bench_dir)
    assert {k: after[k] for k in before} == before
