"""The plain reference agrees with the port on the CPU at tiny sizes, and
the same reference in bfloat16 (the control) reads far above each cell's
limit."""

import json

import numpy as np
import pytest
import torch

from benchmark import inputs
from benchmark.reference import direct, fista, pd_tv
from benchmark.reference.common import rel_l2
from benchmark.reference.projector import Operator
from benchmark.tests.tiny import REPO


def _limit(cell):
    return json.loads((REPO / "benchmark" / "workloads" / f"{cell}.json").read_text())["limits"]["rel_l2"]


THETA = np.linspace(0, np.pi, 60, endpoint=False)


@pytest.mark.parametrize("nz,os_number", [(1, 1), (3, 1), (2, 5)])
def test_operator_matches_the_port(nz, os_number):
    from tomobar_tpu_torch.geometry import Geometry
    from tomobar_tpu_torch.ops.projector import Projector

    n = 48
    P = Projector(Geometry(n, nz, THETA, 0.0, n, os_number=os_number))
    vol = torch.rand((nz, n, n), generator=torch.Generator().manual_seed(3))
    for s, ind in enumerate(P.subset_indices):
        op = Operator(THETA[ind], 0.0, n, n, "cpu")
        fp = P.fp_sub(vol, s) if os_number > 1 else P.fp(vol)
        assert rel_l2(op.fp(vol), fp) < 1e-6
        assert rel_l2(op.bp(fp), P.bp_sub(fp, s) if os_number > 1 else P.bp(fp)) < 1e-6
        assert rel_l2(Operator(THETA[ind], 0.0, n, n, "cpu", "bf16").fp(vol), fp) > 1e-3


@pytest.mark.parametrize("nz", [1, 3])
def test_pd_tv_matches_the_port(nz):
    from tomobar_tpu_torch.regularisers import PD_TV

    d = torch.rand((nz, 32, 40), generator=torch.Generator().manual_seed(4))
    ref = pd_tv.pd_tv(d, 0.05, 20)
    assert rel_l2(PD_TV(d, 0.05, 20, 0, 1, 12.0), ref) < 1e-6
    assert rel_l2(pd_tv.pd_tv(d, 0.05, 20, prec="bf16"), ref) > 1e-3


def _sino(nz, noise):
    s = inputs.clean_sinogram(THETA, 64, 64, 64, np.arange(29, 29 + nz), 0.0, "cpu")
    return inputs.noisy(s, 8000.0, 64, torch.Generator().manual_seed(6)) if noise else s


def test_fista_matches_the_port_and_bf16_fails():
    from tomobar_tpu_torch import RecToolsIRCuPy

    sino = _sino(4, True)
    regul = {"method": "PD_TV", "regul_param": 8e-3, "iterations": 20}
    rt = RecToolsIRCuPy(64, 0, 4, 0.0, THETA, 64, OS_number=10, device="cpu")
    prog = rt.FISTA({"projection_data": sino.clone(), "data_fidelity": "PWLS"},
                    {"iterations": 3, "nonnegativity": True}, dict(regul))
    ref = fista.fista(sino, THETA, 0.0, 64, 10, 3, regul)
    limit = min(_limit("fista_pdtv.chunk20"), _limit("fista_pdtv.chunk8"))
    assert rel_l2(prog, ref) < limit / 10
    # bfloat16 reads ~0.95 at the cells' size (3 seeds on the card), ~0.05 here
    assert rel_l2(fista.fista(sino, THETA, 0.0, 64, 10, 3, regul, "bf16"), ref) > limit


def test_fourier_inv_matches_the_port_and_bf16_fails():
    from tomobar_tpu_torch import RecToolsDIRCuPy

    sino = _sino(4, False)
    prog = RecToolsDIRCuPy(64, 0, 4, 0.0, THETA, 64, device="cpu").FOURIER_INV(sino.clone())
    ref = direct.fourier_inv(sino, THETA, 0.0, 64)
    limit = _limit("direct.fourier_inv.chunk512")
    assert rel_l2(prog, ref) < limit / 10
    assert rel_l2(direct.fourier_inv(sino, THETA, 0.0, 64, "bf16"), ref) > 3 * limit


def test_fbp_matches_the_port_and_bf16_fails():
    from tomobar_tpu_torch import RecToolsDIRCuPy

    sino = _sino(1, False)[0]
    prog = RecToolsDIRCuPy(64, 0, None, 0.0, THETA, 64, device="cpu").FBP(sino.clone())
    ref = direct.fbp(sino, THETA, 0.0, 64, 1.1)
    limit = _limit("direct.fbp2d.preview")
    assert rel_l2(prog, ref) < limit / 10
    assert rel_l2(direct.fbp(sino, THETA, 0.0, 64, 1.1, "bf16"), ref) > 3 * limit
