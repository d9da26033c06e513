"""The port's projector, FBP and FOURIER_INV against the closed-form Radon
transform of ellipses (``tomobar_tpu_torch.bench.analytic``): the cases of
``tests/test_crosscheck_analytic.py`` run on the port, at its sizes (N 256,
360 angles) and its CPU thresholds.

* ``radon_fp`` within 1% rel L2 of the continuous transform; negated
  angles and a mirrored detector more than 5% away; a centre offset of
  +3.5 matches and -3.5 is more than 5% away;
* FBP (ram-lak) of the exact sinogram: the flat interior of the unit
  ellipse 1.0 +- 0.03, the rel RMSE inside the inscribed circle < 0.10;
* FOURIER_INV: the flat interior over its 8/pi convention 1.0 +- 0.06, and
  the reconstruction beats each of its four 1-pixel shifts.

Each projector case runs on the two-pass pair (``"pallas"``, the operator
that the card's kernels K1-K4 and K1p/K4p compute) and on the Joseph pair
(``"xla"``).  Beside them: one slice through ``RecToolsDIR.FORWPROJ``, a
4-slice stack whose slices carry other values, and parity with the JAX
package on the same inputs: ``radon_fp`` within 1e-5 of the largest value
(the Joseph pairs, as ``tests/test_torch_joseph.py``), 2D FBP within 5e-5
and FOURIER_INV within 2e-5 (as ``tests/test_torch_direct.py``).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tomobar_tpu import RecToolsDIR as JaxDIR
from tomobar_tpu import RecToolsDIRCuPy as JaxDIRCuPy
from tomobar_tpu.geometry import Geometry as JaxGeometry
from tomobar_tpu.ops.projector import radon_fp as jax_radon_fp

from tomobar_tpu_torch import RecToolsDIR, RecToolsDIRCuPy
from tomobar_tpu_torch.bench import analytic as AN
from tomobar_tpu_torch.geometry import Geometry
from tomobar_tpu_torch.ops import projector as TP
from tomobar_tpu_torch.ops.projector import radon_fp

torch.set_num_threads(1)

N, NANG, NZ = 256, 360, 4
COR = 3.5
TOL_FP = 0.01  # rel L2 against the continuous transform (0.37% measured)
MIN_FLIP = 0.05  # rel L2 of a flipped convention (10.1% and 17.6% measured)
TOL_FLAT_FBP, MAX_RMSE_FBP = 0.03, 0.10
TOL_FLAT_FI = 0.06
TOL_JAX_FP, TOL_JAX_FBP, TOL_JAX_FI = 1e-5, 5e-5, 2e-5  # of the largest value
# slice k of the stack: every value times 1 + k/8
VALUES = 1.0 + np.arange(NZ) / 8.0
BACKENDS = ["pallas", "xla"]


@pytest.fixture(params=BACKENDS)
def backend(request, monkeypatch):
    """The port's projector on ``request.param``; the backend comes back after."""
    monkeypatch.setattr(TP, "_BACKEND", TP._BACKEND)
    TP.set_projector_backend(request.param)
    return request.param


@pytest.fixture(scope="module")
def angles():
    return np.linspace(0, np.pi, NANG, endpoint=False)


@pytest.fixture(scope="module")
def phantom():
    return AN.ellipse_phantom(N, AN.ELLIPSES)


@pytest.fixture(scope="module")
def ana_sino(angles):
    return AN.ellipse_sinogram(angles, N, AN.ELLIPSES)


def _fp(phantom, angles, cor=0.0):
    geom = Geometry(N, None, angles, cor, N)
    return radon_fp(torch.as_tensor(phantom), geom).numpy()


def _check_fbp(rec, truth, value=1.0):
    flat = float(rec[AN.flat_interior_mask(N)].mean()) / value
    assert abs(flat - 1.0) < TOL_FLAT_FBP, flat
    rel = AN.rel_rmse(rec, truth, AN.incircle_mask(N))
    assert rel < MAX_RMSE_FBP, rel


class TestForwardProjector:
    def test_fp_matches_continuous_radon(self, backend, angles, phantom, ana_sino):
        assert AN.rel_l2(_fp(phantom, angles), ana_sino) < TOL_FP

    def test_convention_flips_rejected(self, backend, angles, phantom, ana_sino):
        fp = _fp(phantom, angles)
        assert AN.rel_l2(fp, AN.ellipse_sinogram(-angles, N, AN.ELLIPSES)) > MIN_FLIP
        assert AN.rel_l2(fp, ana_sino[:, ::-1]) > MIN_FLIP

    def test_cor_is_positive_detector_shift(self, backend, angles, phantom):
        fp = _fp(phantom, angles, COR)
        assert AN.rel_l2(fp, AN.ellipse_sinogram(angles, N, AN.ELLIPSES, COR)) < TOL_FP
        assert AN.rel_l2(fp, AN.ellipse_sinogram(angles, N, AN.ELLIPSES, -COR)) > MIN_FLIP

    def test_forwproj_one_slice(self, backend, angles, phantom, ana_sino):
        """2D ``FORWPROJ``: the packed K1p path on a card."""
        one = RecToolsDIR(N, 0, None, 0.0, angles, N, device="cpu").FORWPROJ(phantom)
        assert one.shape == (NANG, N)
        assert AN.rel_l2(one, ana_sino) < TOL_FP

    def test_forwproj_stack(self, backend, angles, phantom, ana_sino):
        """3D ``FORWPROJ`` of a stack whose slices carry other values, on
        every other angle: each slice meets the threshold."""
        vol = VALUES[:, None, None].astype(np.float32) * phantom
        stack = RecToolsDIR(N, 0, NZ, 0.0, angles[::2], N, device="cpu").FORWPROJ(vol)
        assert stack.shape == (NZ, NANG // 2, N)
        for k, v in enumerate(VALUES):
            assert AN.rel_l2(stack[k], v * ana_sino[::2]) < TOL_FP, k


class TestFBPCalibration:
    def test_fbp_2d_absolute_amplitude(self, backend, angles, phantom, ana_sino):
        rec = RecToolsDIR(N, 0, None, 0.0, angles, N, device="cpu").FBP(
            ana_sino, filter_type="ram-lak")
        _check_fbp(rec, phantom)

    def test_fbp_3d_absolute_amplitude(self, backend, angles, phantom, ana_sino):
        """3D FBP of a 2-slice stack (values 1 and 1.125), data as
        ``[angles, detY, detX]``: each slice on its own scale."""
        values = VALUES[:2]
        data = np.stack([v * ana_sino for v in values], 1)
        rec = RecToolsDIR(N, 0, 2, 0.0, angles, N, device="cpu").FBP(
            data, filter_type="ram-lak")
        for k, v in enumerate(values):
            _check_fbp(rec[k], v * phantom, v)


class TestFourierInvRegistration:
    @pytest.mark.parametrize("nz", [0, 2])
    def test_amplitude_and_subpixel_registration(self, angles, phantom, ana_sino, nz):
        """2D data (promoted to one slice) and a 2-slice stack."""
        values = VALUES[:max(nz, 1)]
        data = ana_sino if nz == 0 else np.stack([v * ana_sino for v in values])
        fi = RecToolsDIRCuPy(N, 0, nz, 0.0, angles, N, device="cpu").FOURIER_INV(
            data, filter_type="ramp").numpy()
        fi = fi.reshape(len(values), N, N) / AN.FOURIER_INV_SCALE
        for k, v in enumerate(values):
            flat = float(fi[k][AN.flat_interior_mask(N)].mean()) / v
            assert abs(flat - 1.0) < TOL_FLAT_FI, (k, flat)
        base, shifted = AN.shift_rmse(fi[0], phantom, AN.incircle_mask(N))
        for d, rmse in shifted.items():
            assert rmse > base, (d, rmse, base)


class TestParityWithJax:
    """The JAX package's CPU path (its Joseph pair and XLA gridding) and the
    port on the same inputs."""

    def test_radon_fp(self, monkeypatch, angles, phantom):
        monkeypatch.setattr(TP, "_BACKEND", TP._BACKEND)
        TP.set_projector_backend("xla")
        want = np.asarray(jax_radon_fp(
            jnp.asarray(phantom), JaxGeometry(N, None, angles, COR, N)))
        got = _fp(phantom, angles, COR)
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL_JAX_FP * np.abs(want).max())

    def test_fbp(self, monkeypatch, angles, ana_sino):
        monkeypatch.setattr(TP, "_BACKEND", TP._BACKEND)
        TP.set_projector_backend("xla")
        want = np.asarray(JaxDIR(N, 0, None, 0.0, angles, N).FBP(
            ana_sino, filter_type="ram-lak"))
        got = RecToolsDIR(N, 0, None, 0.0, angles, N, device="cpu").FBP(
            ana_sino, filter_type="ram-lak")
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL_JAX_FBP * np.abs(want).max())

    def test_fourier_inv(self, angles, ana_sino):
        want = np.asarray(JaxDIRCuPy(N, 0, 0, 0.0, angles, N).FOURIER_INV(
            jnp.asarray(ana_sino), filter_type="ramp"))
        got = RecToolsDIRCuPy(N, 0, 0, 0.0, angles, N, device="cpu").FOURIER_INV(
            ana_sino, filter_type="ramp").numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL_JAX_FI * np.abs(want).max())
