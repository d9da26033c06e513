"""Port parity: data-fidelity gradients, dictionaries, helpers and the
package boundary of tomobar_tpu_torch.

``grad_data_term`` is compared with the JAX package's on its Pallas
projector backend in interpret mode, which is the operator the port's
kernels compute; the tolerance 5e-5 * max|ref| covers the Pallas bf16x3
matmul products (see ``tests/test_torch_projector.py``).
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tomobar_tpu import fidelity as jax_fidelity
from tomobar_tpu.geometry import Geometry as JaxGeometry
from tomobar_tpu.ops import projector as jax_projector
from tomobar_tpu.ops import projector_pallas as PP
from tomobar_tpu.utils import dicts as jax_dicts
from tomobar_tpu.utils import tools as jax_tools

from tomobar_tpu_torch import RecToolsIRCuPy, fidelity
from tomobar_tpu_torch.convert import geometry_from_reference, tensor_from_reference
from tomobar_tpu_torch.ops.projector import Projector
from tomobar_tpu_torch.utils import dicts, tools

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
N, NZ, N_ANG = 64, 2, 16


@pytest.fixture()
def jax_pallas(monkeypatch):
    monkeypatch.setattr(jax_projector, "_BACKEND", "pallas")
    PP._INTERPRET[0] = True
    yield
    PP._INTERPRET[0] = False


@pytest.fixture(scope="module")
def problem():
    angles = np.linspace(0.0, np.pi, N_ANG, endpoint=False)
    jg = JaxGeometry(
        detectors_x=N, detectors_y=NZ, angles=angles, center_rot_offset=1.5,
        recon_size=N, os_number=2,
    )
    rng = np.random.default_rng(21)
    x = np.abs(rng.standard_normal((NZ, N, N))).astype(np.float32)
    b = (np.abs(rng.standard_normal((NZ, N_ANG // 2, N))) * 20.0).astype(np.float32)
    w = rng.uniform(0.2, 1.0, (NZ, N_ANG // 2, N)).astype(np.float32)
    return jg, x, b, w


@pytest.mark.parametrize(
    "fid,kw",
    [
        ("LS", {}),
        ("PWLS", {}),
        ("KL", {}),
        ("LS", {"huber_threshold": 5.0}),
        ("PWLS", {"studentst_threshold": 3.0}),
    ],
    ids=["LS", "PWLS", "KL", "huber", "studentst"],
)
def test_grad_data_term_matches_jax(jax_pallas, problem, fid, kw):
    jg, x, b, w = problem
    use_w = w if fid == "PWLS" else None
    ref = np.asarray(
        jax_fidelity.grad_data_term(
            jax_projector.Projector(jg), jnp.asarray(x), jnp.asarray(b),
            sub_ind=1, w=None if use_w is None else jnp.asarray(use_w),
            fidelity=fid, **kw,
        )
    )
    port = fidelity.grad_data_term(
        Projector(geometry_from_reference(jg)), torch.from_numpy(x),
        torch.from_numpy(b), sub_ind=1,
        w=None if use_w is None else torch.from_numpy(use_w), fidelity=fid, **kw,
    ).numpy()
    assert port.shape == ref.shape
    assert np.abs(port - ref).max() <= 5e-5 * np.abs(ref).max()


@pytest.mark.parametrize("n_ang", [15, 16])  # odd and even angle counts
def test_swls_weights_match_jax(n_ang):
    rng = np.random.default_rng(22)
    b = rng.standard_normal((3, n_ang, 40)).astype(np.float32)
    b[:, :, 17] += 2.0  # a stripe
    ref = np.asarray(jax_fidelity.swls_weights(jnp.asarray(b), 0.1))
    port = fidelity.swls_weights(torch.from_numpy(b), 0.1).numpy()
    np.testing.assert_allclose(port, ref, rtol=1e-6, atol=1e-7)


class _Owner:
    OS_number = 3


def test_dicts_check_defaults_match_jax():
    sino = np.zeros((N_ANG, N), np.float32)
    args = ({"iterations": 4}, {"method": "PD_TV"}, "FISTA")
    ref = jax_dicts.dicts_check(
        _Owner(), {"projection_data": sino, "data_fidelity": "PWLS"}, *args[:2], args[2]
    )
    port = dicts.dicts_check(
        _Owner(), {"projection_data": sino, "data_fidelity": "PWLS"}, *args[:2], args[2]
    )
    assert np.asarray(port[0]["projection_data"]).shape == (1, N_ANG, N)
    assert np.asarray(ref[0]["projection_data"]).shape == (1, N_ANG, N)
    assert port[1] == ref[1]
    assert port[2] == ref[2]


def test_tools_match_jax():
    rng = np.random.default_rng(23)
    vol = rng.standard_normal((2, 40, 40)).astype(np.float32)
    sino = rng.standard_normal((2, 7, 30)).astype(np.float32)
    t = torch.from_numpy
    for radius in (1.0, 0.8, 2.0):
        np.testing.assert_array_equal(
            tools.apply_circular_mask(t(vol), radius).numpy(),
            np.asarray(jax_tools.apply_circular_mask(vol, radius)),
        )
    np.testing.assert_array_equal(
        tools.perform_recon_crop(t(vol), 30).numpy(),
        jax_tools.perform_recon_crop(vol, 30),
    )
    np.testing.assert_array_equal(
        tools.apply_horiz_detector_padding(t(sino), 5).numpy(),
        jax_tools.apply_horiz_detector_padding(sino, 5),
    )
    np.testing.assert_array_equal(
        tools.apply_horiz_detector_padding(t(sino[0]), 3).numpy(),
        jax_tools.apply_horiz_detector_padding(sino[0], 3),
    )
    order = ["detX", "detY", "angles"]
    target = ["detY", "angles", "detX"]
    assert tools.swap_data_axes_to_accepted(
        order, target
    ) == jax_tools.swap_data_axes_to_accepted(order, target)
    np.testing.assert_array_equal(
        tools.data_dims_swapper(t(sino), order, target).numpy(),
        jax_tools.data_dims_swapper(sino, order, target),
    )


@pytest.mark.parametrize("cupyrun", [None, False, True], ids=["default", "cupyrun=False", "cupyrun=True"])
@pytest.mark.parametrize("ndim", [2, 3])
def test_tools_take_numpy_and_cupyrun_as_jax(ndim, cupyrun):
    """``apply_circular_mask``, ``apply_horiz_detector_padding`` and
    ``check_kwargs`` take what the JAX package's take: a numpy array (and give
    a numpy array back) and the ``cupyrun`` argument, positional or by name.
    The same numpy inputs through both packages, exact equality; a tensor in
    gives the same values as a tensor."""
    rng = np.random.default_rng(29 + ndim)
    vol = rng.standard_normal((2, 40, 40)[3 - ndim:]).astype(np.float32)
    sino = rng.standard_normal((2, 7, 30)[3 - ndim:]).astype(np.float32)
    extra = () if cupyrun is None else (cupyrun,)
    named = {} if cupyrun is None else {"cupyrun": cupyrun}
    for radius in (1.0, 0.8, 2.0):
        ref = np.asarray(jax_tools.apply_circular_mask(vol, radius, *extra))
        for got in (tools.apply_circular_mask(vol, radius, *extra),
                    tools.apply_circular_mask(vol, radius, **named),
                    tools.check_kwargs(vol, recon_mask_radius=radius, **named)):
            assert isinstance(got, np.ndarray) and got.dtype == ref.dtype
            np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(
            np.asarray(jax_tools.check_kwargs(vol, recon_mask_radius=radius, **named)), ref)
        as_tensor = tools.check_kwargs(torch.from_numpy(vol), recon_mask_radius=radius, **named)
        assert isinstance(as_tensor, torch.Tensor)
        np.testing.assert_array_equal(as_tensor.numpy(), ref)
    assert tools.check_kwargs(vol, recon_mask_radius=None, **named) is vol
    for pad in (0, 4):
        ref = np.asarray(jax_tools.apply_horiz_detector_padding(sino, pad, *extra))
        for got in (tools.apply_horiz_detector_padding(sino, pad, *extra),
                    tools.apply_horiz_detector_padding(sino, pad, **named)):
            assert isinstance(got, np.ndarray) and got.dtype == ref.dtype
            np.testing.assert_array_equal(got, ref)
        as_tensor = tools.apply_horiz_detector_padding(torch.from_numpy(sino), pad, *extra)
        np.testing.assert_array_equal(as_tensor.numpy(), ref)
    np.testing.assert_array_equal(tools.perform_recon_crop(vol, 30),
                                  jax_tools.perform_recon_crop(vol, 30))


def test_convert_checks_layout_and_dtype():
    jg = JaxGeometry(
        detectors_x=N, detectors_y=NZ, angles=np.linspace(0, np.pi, 5),
        center_rot_offset=np.linspace(-1, 1, 5), recon_size=N, os_number=2,
    )
    g = geometry_from_reference(jg)
    np.testing.assert_array_equal(g.cor_horizontal, jg.cor_horizontal)
    assert (g.detectors_x_total, g.os_number, g.n_angles) == (N, 2, 5)
    t = tensor_from_reference(np.ones((2, 5, N), np.float64), "sinogram")
    assert t.dtype == torch.float32 and t.shape == (2, 5, N)
    with pytest.raises(ValueError):
        tensor_from_reference(np.ones((5, N)), "sinogram")
    with pytest.raises(ValueError):
        tensor_from_reference(np.ones((2, 8, 9)), "volume")
    with pytest.raises(TypeError):
        tensor_from_reference(np.ones((2, 8, 8), np.int32), "volume")
    with pytest.raises(ValueError):
        tensor_from_reference(np.ones((2, 8, 8)), "zyx")


def test_import_leaves_jax_out():
    """(j) the port never imports jax or tomobar_tpu."""
    code = (
        "import sys, tomobar_tpu_torch\n"
        "import tomobar_tpu_torch.ops.projector, tomobar_tpu_torch.ops.pd_tv\n"
        "import tomobar_tpu_torch.convert, tomobar_tpu_torch.solvers.core\n"
        "import tomobar_tpu_torch.regularisers_legacy, tomobar_tpu_torch.ops.usfft\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'tomobar_tpu' or m.startswith('tomobar_tpu.')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_cuda_device_raises_without_cuda():
    """(k) the constructor never drops to the CPU by itself."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    angles = np.linspace(0.0, np.pi, 8, endpoint=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        RecToolsIRCuPy(N, 0, NZ, 0.0, angles, N)
    with pytest.raises(RuntimeError, match="CUDA"):
        RecToolsIRCuPy(N, 0, NZ, 0.0, angles, N, device="cuda")


@pytest.mark.parametrize("size", [37, 64, 301])
def test_circular_mask_made_by_torch_equals_the_numpy_mask(size):
    """A tensor's mask is made with torch where the tensor lies; it must be
    the JAX package's numpy mask exactly, at every radius, also where a
    pixel's distance equals the limit (odd and even sizes)."""
    ones = np.ones((size, size), np.float32)
    for radius in (0.3, 0.5, 0.8, 0.95, 1.0, 1.2, 2.0):
        ref = np.asarray(jax_tools.apply_circular_mask(ones, radius))
        got = tools.apply_circular_mask(torch.from_numpy(ones), radius)
        np.testing.assert_array_equal(got.numpy(), ref)
        np.testing.assert_array_equal(tools.apply_circular_mask(ones, radius), ref)
