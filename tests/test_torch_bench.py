"""The port's headline benchmark (``recfilter_tpu_torch.bench``) and its
bandwidth probe (``kernels/copy.py``) on the CPU: the filter against the
root ``bench.py``'s, the copy twin, and the JSON line's keys.
"""

import dataclasses
import importlib.util
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recfilter_tpu import scan_core as jsc

from recfilter_tpu_torch import bench as tbench
from recfilter_tpu_torch.kernels import copy as tcopy
from recfilter_tpu_torch.kernels import launch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _root_bench():
    spec = importlib.util.spec_from_file_location(
        "root_bench", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fields(spec):
    """A FilterSpec of either package as plain values."""
    return (spec.name, tuple((d.name, d.extent) for d in spec.dims),
            tuple(dataclasses.astuple(s) for s in spec.scans), spec.border,
            spec.dtype, tuple(spec.tile_widths))


@pytest.mark.parametrize("h,w", [(256, 256), (256, 384)])
def test_build_filter_matches_root_bench(h, w):
    """The same spec as ``bench.py::_build_filter``, and the same output
    on one image (1e-5 of the peak: the JAX px6 path's fp32 glue), the
    port within px6 of the f64 oracle."""
    Fj = _root_bench()._build_filter(h, w)
    Ft = tbench._build_filter(h, w)
    assert _fields(Ft.spec) == _fields(Fj.spec)
    img = (np.random.default_rng(0).standard_normal((h, w)) * 0.01
           ).astype(np.float32)
    got = Ft.realize(img, device="cpu").numpy()
    want = np.asarray(Fj.realize(jnp.asarray(img)))
    oracle = jsc.oracle_apply(Fj.spec, img.astype(np.float64))
    peak = np.abs(oracle).max()
    assert np.abs(got - want).max() <= 1e-5 * peak
    assert np.abs(got - oracle).max() <= 2e-6 * peak


@pytest.mark.parametrize("shape", [(7,), (4096,), (3, 5, 129)])
def test_copy_twin(shape):
    """``copy`` on a CPU tensor is its twin, 1.0001·x in float32, bit for
    bit, in a new tensor; no kernel launches."""
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(shape)
                         .astype(np.float32))
    launch.reset_launches()
    y = tcopy.copy(x)
    assert launch.LAUNCHES["copy"] == 0
    assert y.dtype == torch.float32 and y.data_ptr() != x.data_ptr()
    want = (x.numpy() * np.float32(1.0001)).astype(np.float32)
    np.testing.assert_array_equal(y.numpy(), want)
    assert torch.equal(tcopy.plain(x), y)


def test_main_prints_bench_keys_on_the_cpu(capsys):
    """``main(device="cpu")`` prints bench.py's JSON keys (with
    ``throughput_mode_mpix_s``), the device and the bandwidth, and its
    stderr line."""
    out = tbench.main(device="cpu", h=256, w=256, iterations=3)
    lines = capsys.readouterr()
    printed = json.loads(lines.out.strip().splitlines()[-1])
    assert printed == out
    assert set(out) == {"metric", "value", "unit", "vs_baseline",
                        "precision_mode", "pipeline", "device",
                        "measured_bw_gb_s", "throughput_mode_mpix_s"}
    assert out["metric"] == "gaussian_iir_4k_mpix_s"
    assert out["unit"] == "Mpix/s"
    assert out["precision_mode"] == "px6 (true-f32 default)"
    assert out["pipeline"] == ("3-touch overlapped (12 B/px; raw moments, "
                               "glue carries)")
    assert out["device"].startswith("cpu")
    # host-clock numbers of a loaded CPU: finite, not measured values
    for key in ("value", "vs_baseline", "measured_bw_gb_s",
                "throughput_mode_mpix_s"):
        assert isinstance(out[key], float) and np.isfinite(out[key])
    assert "[bench] platform=cpu" in lines.err
    assert "[throughput mode: " in lines.err and "Mpix/s]" in lines.err


def test_main_names_the_routes(monkeypatch, capsys):
    """With both carry routes turned on, ``pipeline`` names them."""
    monkeypatch.setenv("RECFILTER_PX2D_BK", "1")
    monkeypatch.setenv("RECFILTER_PXM_NAF", "1")
    out = tbench.main(device="cpu", h=256, w=256, iterations=1)
    assert out["pipeline"] == ("3-touch overlapped (12 B/px; naf moments, "
                               "bsolve carries)")


def test_bench_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the refusal applies without it")
    with pytest.raises(RuntimeError, match="cuda"):
        tbench.main()
    with pytest.raises(RuntimeError, match="cuda"):
        tbench.measure_bandwidth(256, 256)


@pytest.mark.parametrize("h,w", [(256, 256), (256, 384)])
def test_throughput_mode_filter_matches_root_bench(h, w):
    """The throughput mode's filter: ``bench.py``'s at
    ``matmul_precision="default"``, on ``final2d_split`` at one product
    (the CPU twin here), within 3e-2 of the f64 oracle's peak and closer
    to it than the root bench's own throughput-mode filter, which takes
    one product on the carries too and lands past 3e-2 of the peak here
    (the port takes three there: ``split.carry_nprod``)."""
    from recfilter_tpu_torch.kernels.final2d import Final2DSplit

    Ft = tbench._build_filter(h, w)
    Ft.set_plan(matmul_precision="default")
    fn = Ft.as_func(device="cpu")
    assert isinstance(fn.final, Final2DSplit) and fn.final.nprod == 1
    Fj = _root_bench()._build_filter(h, w)
    Fj.set_plan(matmul_precision="default")
    img = (np.random.default_rng(0).standard_normal((h, w)) * 0.01
           ).astype(np.float32)
    got = fn(torch.from_numpy(img)).numpy()
    want = np.asarray(Fj.realize(jnp.asarray(img)))
    oracle = jsc.oracle_apply(Fj.spec, img.astype(np.float64))
    peak = np.abs(oracle).max()
    assert np.abs(got - oracle).max() <= 3e-2 * peak
    assert np.abs(got - oracle).max() < np.abs(want - oracle).max()
