"""The bf16 error of the k-NN (tau) fused KPConv at encoder1_1 (Cin = 4 ->
64), in the JAX reference and in the port, on the same inputs.

chip_smoke.py gates kernel #7 in bf16 at rel <= 5e-2 against the fp32
plain version; at encoder1_1 its reading was 4.19e-02 on one draw and
6.097e-02 on another.  Here, over the seeds that
tests/test_torch_cuda_kernels.py::test_kpconv_tau_bf16_error_at_cin4_tracks_the_plain_version
gives the kernel on the card, the JAX reference's bf16 path
(``banded_kpconv_fused_tau_pallas`` with ``dtype=bfloat16``, in interpret
mode) and the port's plain bf16 version are held against one fp32 truth,
the port's fp32 plain version.  Their errors agree to 1e-3 on every draw
(they read 3.57e-2 to 8.80e-2 and agree to four digits): both round
features, influence-weighted sums and weights to bf16 and accumulate in
fp32.  Their outputs lie within 2e-2 of each other (rel, rms-floored;
1.2e-2 at most over these draws): the reference takes the influence from
an fp32 matrix-product identity, the port in float64, and where the two
differ in fp32's last bits a weighted sum rounds to the neighbouring bf16
value (2^-8 relative).  So a reading over the gate is the reference's own
bf16 behaviour at four input channels: it reads 8.80e-2 on the sixth of
these draws and 3.57e-2 to 3.77e-2 on the others.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cofii2p_tpu.ops.kpconv_kernel import banded_kpconv_fused_tau_pallas
from cofii2p_tpu_torch.ops.kpconv_kernel import banded_kpconv_fused_tau_plain
from tests.torch_parity import rel_err
from torch_kernel_inputs import ENC1_1_BW, ENC1_1_R, ENC1_1_S, ENC1_1_SEEDS, enc1_1_tau_inputs

GATE = 5e-2  # chip_smoke.py's bf16 gate of the tau KPConvs
_READINGS = {}


def readings(seed):
    """(error of the JAX reference's bf16 path, error of the port's plain
    bf16 version, their distance from each other), each rel_err against the
    port's fp32 plain version, on bf16 features."""
    if seed not in _READINGS:
        f, s, w, tau, kp = enc1_1_tau_inputs(seed)
        t = [torch.as_tensor(x) for x in (s, s, w, tau, kp)]
        truth, _ = banded_kpconv_fused_tau_plain(torch.as_tensor(f), *t, ENC1_1_R, ENC1_1_S, 15, 128, ENC1_1_BW)
        port, _ = banded_kpconv_fused_tau_plain(torch.as_tensor(f).bfloat16(), *t, ENC1_1_R, ENC1_1_S, 15, 128,
                                                ENC1_1_BW, torch.bfloat16)
        j = [jnp.asarray(x) for x in (s, s, w, tau, kp)]
        ref, _ = banded_kpconv_fused_tau_pallas(jnp.asarray(f).astype(jnp.bfloat16), *j, ENC1_1_R, ENC1_1_S, 15, 128,
                                                ENC1_1_BW, jnp.bfloat16)
        ref = torch.as_tensor(np.asarray(ref))
        _READINGS[seed] = (rel_err(ref, truth), rel_err(port, truth), rel_err(port, ref))
        print(f"encoder1_1 seed {seed}: reference {_READINGS[seed][0]:.4e}, port {_READINGS[seed][1]:.4e}, "
              f"apart {_READINGS[seed][2]:.3e}")
    return _READINGS[seed]


@pytest.mark.parametrize("seed", ENC1_1_SEEDS)
def test_port_bf16_error_is_the_references(seed):
    """On each draw the port's plain bf16 version errs as the reference's
    bf16 path does, and the two outputs lie within 2e-2 of each other."""
    e_ref, e_port, apart = readings(seed)
    assert abs(e_port - e_ref) <= 1e-3, (e_ref, e_port)
    assert apart <= 2e-2


def test_reference_reads_over_the_gate_on_one_draw():
    """The reference itself reads over the 5e-2 gate on one of the draws
    (ROADMAP.md, "Known reference behaviours"), and under it on the rest."""
    errs = [readings(seed)[0] for seed in ENC1_1_SEEDS]
    assert sum(e > GATE for e in errs) >= 1, errs
    assert sum(e <= GATE for e in errs) >= 1, errs
