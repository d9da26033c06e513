"""Port parity of the direct path: ``RecToolsDIR``/``RecToolsDIRCuPy`` of
tomobar_tpu_torch on the CPU against the JAX package.

* ``FOURIER_INV`` meets the frozen ``GOLDEN_CPU["fourier_inv_shepp"]``
  (rtol 3e-4, as ``tests/test_goldens.py``) and matches the JAX package
  on its XLA gridding oracle (2e-5 of max) and on its Pallas gridding in
  interpret mode (1e-4 of max: the G1 matmul sums in another order).
* 3D ``FBP``/``FORWPROJ``/``BACKPROJ`` match the JAX package on its
  interpret-mode Pallas projector (5e-5 of max: the Pallas bf16x3 products,
  as ``tests/test_torch_projector.py``).
* ``FOURIER`` 2D matches the JAX package (2e-5 of max).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from conftest import shepp_logan_slice
from test_goldens import GOLDEN_CPU, RTOL
from tomobar_tpu import RecToolsDIR as JaxDIRhost
from tomobar_tpu import RecToolsDIRCuPy as JaxDIR
from tomobar_tpu.ops import projector as jax_projector
from tomobar_tpu.ops import projector_pallas as PP
from tomobar_tpu.ops import usfft as JU
from tomobar_tpu.ops import usfft_pallas

import tomobar_tpu_torch
from tomobar_tpu_torch import RecToolsDIR, RecToolsDIRCuPy, RecToolsDIRTPU
from tomobar_tpu_torch.convert import geometry_from_reference
from tomobar_tpu_torch.geometry import Geometry
from tomobar_tpu_torch.ops.projector import radon_fp

torch.set_num_threads(1)

TOL_PIPE = 2e-5
TOL_PALLAS_GRID = 1e-4
TOL_PROJ = 5e-5


@pytest.fixture()
def jax_pallas(monkeypatch):
    monkeypatch.setattr(jax_projector, "_BACKEND", "pallas")
    PP._INTERPRET[0] = True
    yield
    PP._INTERPRET[0] = False


def _close(got, want, tol):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


def test_exports_and_aliases():
    assert RecToolsDIRCuPy is RecToolsDIRTPU
    assert {"RecToolsDIR", "RecToolsDIRTPU", "RecToolsDIRCuPy"} <= set(
        tomobar_tpu_torch.__all__
    )


def test_fourier_inv_meets_golden_and_jax(sino3d, angles180):
    want = np.asarray(
        JaxDIR(64, 0, 4, 0.0, angles180, 64).FOURIER_INV(
            jnp.asarray(sino3d), filter_type="shepp"
        )
    )
    rec = RecToolsDIRCuPy(64, 0, 4, 0.0, angles180, 64, device="cpu").FOURIER_INV(
        sino3d, filter_type="shepp"
    )
    assert isinstance(rec, torch.Tensor) and rec.device.type == "cpu"
    got = (float(rec.min()), float(rec.max()), float(rec.mean()))
    for g, w in zip(got, GOLDEN_CPU["fourier_inv_shepp"]):
        assert g == pytest.approx(w, rel=RTOL, abs=1e-7)
    _close(rec, want, TOL_PIPE)


def test_fourier_inv_matches_jax_pallas_gridding(monkeypatch):
    """n = 128 reaches the JAX package's Pallas gridding (n >= 128)."""
    n, nz, nproj = 128, 2, 45
    rng = np.random.default_rng(12)
    angles = np.linspace(0, np.pi, nproj, endpoint=False)
    sino = rng.uniform(0, 1, (nz, nproj, n)).astype(np.float32)
    monkeypatch.setattr(JU, "_USFFT_BACKEND", "pallas")
    monkeypatch.setattr(usfft_pallas, "_INTERPRET", [True])
    want = JaxDIR(n, 0, nz, 0.0, angles, n).FOURIER_INV(jnp.asarray(sino))
    got = RecToolsDIRCuPy(n, 0, nz, 0.0, angles, n, device="cpu").FOURIER_INV(sino)
    _close(got, want, TOL_PALLAS_GRID)


def test_fourier_inv_2d_matches_jax():
    angles = np.linspace(0, np.pi, 50, endpoint=False)
    sino = np.random.default_rng(13).uniform(0, 1, (50, 46)).astype(np.float32)
    want = JaxDIR(46, 0, None, 0.5, angles, 46).FOURIER_INV(
        jnp.asarray(sino.T), data_axes_labels_order=["detX", "angles"]
    )
    got = RecToolsDIRCuPy(46, 0, None, 0.5, angles, 46, device="cpu").FOURIER_INV(
        sino.T, data_axes_labels_order=["detX", "angles"]
    )
    _close(got, want, TOL_PIPE)


@pytest.mark.parametrize("det,cor", [(48, 0.0), (47, 1.5)])
def test_fourier_2d_matches_jax(det, cor):
    angles = np.linspace(0, np.pi, 40, endpoint=False)
    sino = np.random.default_rng(14).uniform(0, 1, (40, det)).astype(np.float32)
    want = JaxDIRhost(det, 0, None, cor, angles, det).FOURIER(sino, method="cubic")
    got = RecToolsDIR(det, 0, None, cor, angles, det, device="cpu").FOURIER(
        sino, method="cubic"
    )
    assert isinstance(got, np.ndarray)
    _close(got, want, TOL_PIPE)


def test_fourier_rejects_3d_and_bad_method():
    rt = RecToolsDIR(32, 0, 2, 0.0, np.linspace(0, np.pi, 8), 32, device="cpu")
    with pytest.raises(ValueError):
        rt.FOURIER(np.zeros((2, 8, 32), np.float32))
    with pytest.raises(ValueError):
        rt.FOURIER(np.zeros((8, 32), np.float32), method="quintic")


def _phantom_sino(n, nz, angles, cor=0.0):
    vol = shepp_logan_slice(n)[None] * np.linspace(0.9, 1.1, nz, dtype=np.float32)[:, None, None]
    g = Geometry(n, nz, angles, cor, n)
    return vol, radon_fp(torch.from_numpy(vol), g).numpy()


@pytest.mark.parametrize(
    "kwargs",
    [
        {},  # sinc filter, cutoff 0.35
        {"cutoff_freq": 0.8, "recon_mask_radius": 0.95},
        {"filter_type": "shepp-logan"},
        {"filter_type": "hamming", "filter_parameter": 0.6, "filter_d": 0.8},
    ],
)
def test_fbp_3d_matches_jax_pallas(jax_pallas, kwargs):
    n, nz = 48, 2
    angles = np.linspace(0, np.pi, 24, endpoint=False)
    _, sino = _phantom_sino(n, nz, angles, cor=1.5)
    data = np.ascontiguousarray(np.swapaxes(sino, 0, 1))  # [angles, detY, detX]
    want = JaxDIR(n, 0, nz, 1.5, angles, n).FBP(jnp.asarray(data), **kwargs)
    got = RecToolsDIRCuPy(n, 0, nz, 1.5, angles, n, device="cpu").FBP(data, **kwargs)
    _close(got, want, TOL_PROJ)


def test_fbp_3d_padding_and_order_match_jax_pallas(jax_pallas):
    n, nz, pad = 40, 2, 4
    angles = np.linspace(0, np.pi, 20, endpoint=False)
    _, sino = _phantom_sino(n, nz, angles)
    order = ["detY", "angles", "detX"]
    want = JaxDIRhost(n, pad, nz, 0.0, angles, n).FBP(
        jnp.asarray(sino), data_axes_labels_order=order, filter_type="ram-lak"
    )
    got = RecToolsDIR(n, pad, nz, 0.0, angles, n, device="cpu").FBP(
        sino, data_axes_labels_order=order, filter_type="ram-lak"
    )
    _close(got, want, TOL_PROJ)


def test_fbp_rejects_wrong_angle_count():
    rt = RecToolsDIR(32, 0, 2, 0.0, np.linspace(0, np.pi, 8), 32, device="cpu")
    with pytest.raises(ValueError):
        rt.FBP(np.zeros((2, 8, 32), np.float32))


def test_forwproj_backproj_3d_match_jax_pallas(jax_pallas):
    n, nz = 40, 2
    angles = np.linspace(0, np.pi, 18, endpoint=False)
    vol, sino = _phantom_sino(n, nz, angles)
    jrt = JaxDIRhost(n, 0, nz, 0.5, angles, n)
    prt = RecToolsDIR(n, 0, nz, 0.5, angles, n, device="cpu")
    order = ["angles", "detY", "detX"]
    _close(prt.FORWPROJ(vol, data_axes_labels_order=order),
           jrt.FORWPROJ(jnp.asarray(vol), data_axes_labels_order=order), TOL_PROJ)
    _close(prt.BACKPROJ(sino), jrt.BACKPROJ(jnp.asarray(sino)), TOL_PROJ)


def test_fourier_inv_correlates_with_fbp_ram_lak():
    """The JAX package's documented property of FOURIER_INV (``usfft.py``):
    inside the inscribed circle it correlates > 0.99 with a Ram-Lak FBP."""
    n, nz = 256, 2
    angles = np.linspace(0, np.pi, 180, endpoint=False)
    _, sino = _phantom_sino(n, nz, angles)
    rt = RecToolsDIRCuPy(n, 0, nz, 0.0, angles, n, device="cpu")
    fi = rt.FOURIER_INV(sino)
    fbp = rt.FBP(np.swapaxes(sino, 0, 1), filter_type="ram-lak")
    yy, xx = np.mgrid[0:n, 0:n]
    m = torch.from_numpy(np.hypot(yy - (n - 1) / 2, xx - (n - 1) / 2) < n / 2 - 2)
    for z in range(nz):
        corr = np.corrcoef(fi[z][m].numpy(), fbp[z][m].numpy())[0, 1]
        assert corr >= 0.99, f"slice {z}: corr {corr}"


@pytest.mark.parametrize("method", ["FBP", "FORWPROJ", "BACKPROJ"])
def test_2d_projector_methods_name_the_next_slice(method):
    """The 2D methods that waited for the packed nz = 1 kernels K1p/K4p run
    now (parity with JAX in ``tests/test_torch_2d.py``): 2D in, 2D out."""
    rt = RecToolsDIR(32, 0, None, 0.0, np.linspace(0, np.pi, 8), 32, device="cpu")
    shape_in, shape_out = ((32, 32), (8, 32)) if method == "FORWPROJ" else ((8, 32), (32, 32))
    data = np.random.default_rng(15).uniform(0, 1, shape_in).astype(np.float32)
    out = getattr(rt, method)(data)
    assert isinstance(out, np.ndarray) and out.shape == shape_out
    assert np.isfinite(out).all() and np.abs(out).max() > 0.0


def test_shape_tuple_names_memest_item():
    rt = RecToolsDIRCuPy(32, 0, 4, 0.0, np.linspace(0, np.pi, 8), 32, device="cpu")
    with pytest.raises(NotImplementedError, match="item 11"):
        rt.FOURIER_INV((4, 8, 32))


def test_cuda_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RecToolsDIRCuPy(32, 0, 4, 0.0, np.linspace(0, np.pi, 8), 32)


def test_convert_takes_the_dir_geometry():
    """``geometry_from_reference`` needs no change for the DIR classes:
    the JAX class's ``.geom`` becomes the port class's geometry."""
    angles = np.linspace(0, np.pi, 12, endpoint=False)
    cor = 0.3 * np.sin(angles)
    for dimv in (4, None):
        jg = JaxDIRhost(40, 3, dimv, cor, angles, 36).geom
        pg = RecToolsDIR(40, 3, dimv, cor, angles, 36, device="cpu").geom
        got = geometry_from_reference(jg)
        for field in ("detectors_x", "detectors_y", "recon_size", "detectors_x_pad", "os_number"):
            assert getattr(got, field) == getattr(pg, field)
        np.testing.assert_array_equal(got.angles, pg.angles)
        np.testing.assert_array_equal(got.cor_horizontal, pg.cor_horizontal)


def test_version_and_geom_detY_match_jax():
    import tomobar_tpu

    assert tomobar_tpu_torch.__version__ == tomobar_tpu.__version__
    angles = np.linspace(0, np.pi, 8, endpoint=False)
    for dim_v in (None, 0, 3):
        port = RecToolsDIR(32, 0, dim_v, 0.0, angles, 32, device="cpu")
        assert port.geom_detY is JaxDIRhost(32, 0, dim_v, 0.0, angles, 32).geom_detY


@pytest.mark.parametrize("kwargs", [{}, {"filter_type": "ram-lak"}])
def test_fbp_3d_z_chunks_equal_unchunked(monkeypatch, jax_pallas, kwargs):
    """3D FBP with the projector's byte budget lowered to one slice per
    chunk equals the single-chunk result bit for bit, and the JAX package's
    (interpret-mode Pallas projector) within the projector's tolerance."""
    from tomobar_tpu_torch.ops import projector as P

    n, nz = 40, 5
    angles = np.linspace(0, np.pi, 20, endpoint=False)
    _, sino = _phantom_sino(n, nz, angles, cor=1.0)
    data = np.ascontiguousarray(np.swapaxes(sino, 0, 1))
    rt = RecToolsDIRCuPy(n, 0, nz, 1.0, angles, n, device="cpu")
    whole = rt.FBP(data, **kwargs)
    monkeypatch.setattr(P, "CHUNK_BYTES", 1)
    got = rt.FBP(data, **kwargs)
    assert torch.equal(got, whole)
    _close(got, JaxDIR(n, 0, nz, 1.0, angles, n).FBP(jnp.asarray(data), **kwargs), TOL_PROJ)


def test_fourier_inv_chunk_model_on_the_cpu_is_the_jax_package_s():
    """On the CPU the chunk count comes from ``mem_budget_gb`` (default 8)
    and only when asked for, as in the JAX package; a chunked call equals
    the unchunked one within the pipeline's tolerance."""
    from tomobar_tpu_torch.ops import usfft as PU

    for kw in ({}, {"min_mem_usage_ifft2": True}, {"min_mem_usage_filter": True, "mem_budget_gb": 1.0},
               {"chunk_count": 3}):
        assert PU._fourier_inv_memory_chunks(512, 2560, kw, torch.device("cpu")) == \
            JU._fourier_inv_memory_chunks(512, 2560, kw)
    angles = np.linspace(0, np.pi, 24, endpoint=False)
    _, sino = _phantom_sino(32, 6, angles)
    rt = RecToolsDIRCuPy(32, 0, 6, 0.0, angles, 32, device="cpu")
    whole = rt.FOURIER_INV(sino)
    _close(rt.FOURIER_INV(sino, chunk_count=3), whole.numpy(), 1e-6)
    _close(rt.FOURIER_INV(sino[:5], chunk_count=2), rt.FOURIER_INV(sino[:5]).numpy(), 1e-6)
