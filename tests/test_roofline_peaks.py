"""benchmarks/roofline.py peak table: shares are computed only against a
card's published data-sheet peaks, keyed by JAX's ``device_kind``."""

import importlib.util
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _roofline():
    spec = importlib.util.spec_from_file_location(
        "roofline", os.path.join(REPO, "benchmarks", "roofline.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB", ""])
def test_unknown_device_kind_raises(kind):
    with pytest.raises(KeyError, match="no published peaks"):
        _roofline().peaks_for(kind)


def test_h100_row():
    row = _roofline().peaks_for("NVIDIA H100 80GB HBM3")
    assert row["hbm_gbs"] == 3350.0
    assert row["f32_tflops"] == 67.0
    assert row["f64_tflops"] == 34.0
    assert row["f64_tensor_tflops"] == 67.0
    assert row["tf32_tensor_tflops"] == 495.0
    assert "data sheet" in row["source"]
