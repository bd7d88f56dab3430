"""The tiling sweep of the output scans K2 and K5
(``hmm_layer_torch/tune_scans.py``): what it would build, and that it needs
a card. The sweep itself runs on the card only."""

import re

import pytest
import torch

from hmm_layer_torch import tune_scans
from hmm_layer_torch.ops import _cuda_build


def _build_default(name, prefix):
    src = _cuda_build.SOURCES[name].read_text()
    return tuple(int(re.search(rf"#define {prefix}_{k} (\d+)", src).group(1))
                 for k in ("G", "TS", "NB", "UNROLL"))


def test_sweep_covers_the_build_and_fits_shared_memory():
    variants = tune_scans._variants(["parent"])
    labels = [v[0] for v in variants]
    assert len(labels) == len(set(labels))
    assert labels[-2:] == ["K2 parent", "K5 parent"]
    for label, name, _, defs in variants[:-2]:
        g, ts, nb, _ = (int(d.split("=")[1]) for d in defs)
        arrays = 1 if name == "sum_product" else 3  # K5 stages u, v and s
        assert arrays * nb * ts * g * 16 * 4 <= tune_scans.SMEM_LIMIT, label
        assert nb >= 2 and 16 * g <= 1024, label
    for kernel, name, prefix in (("K2", "sum_product", "FWD"), ("K5", "affine", "OUT")):
        g, ts, nb, u = _build_default(name, prefix)
        assert f"{kernel} G={g} TS={ts} NB={nb} U={u}" in labels
    assert not tune_scans._variants(["parent"], grid=False)[:-2]


def test_sweep_needs_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("on a card the sweep runs for real (python3 -m hmm_layer_torch.tune_scans)")
    assert tune_scans.main([]) == 1
    assert "needs a CUDA device" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        tune_scans.main(["--e2e"])  # the A/B run needs one --compare directory
