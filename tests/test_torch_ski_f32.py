"""The float32 lattice-dual NLML of ``GPSKIRegression`` against the JAX
package's, on the CPU: ski1m_lattice's data and parameters on a 12⁴ lattice
with n = 20,000, both packages handed the same NumPy probes and
eigen-conventions (tools/ski_reference_jax.py).

The port's float32 NLML sits 5.7e-5 to 5.9e-5 (relative; the count of
CPU threads moves its float32 sums) from the float64 one, the JAX package's
9.0e-6.  Term by term (``tools/ski_f32_gap_jax.py --config
ski1m_lattice --m 12 --n 20000``) both packages' ``ld_MK`` and ``ld_white``
move alike under float32 (the eigenvalue clamp of the float32 model); the
difference is yᵀy in ``quad = (yᵀy − 2ṽᵀγ + γᵀW̃γ)/σ²``.  The JAX package's
float32 ``jnp.dot`` on the CPU sums in index order and lands 6.6e-6 below
the exact yᵀy; the port's is within 1e-7.  quad cancels yᵀy down to 1/127
of itself and divides by σ² = 0.05, so that rounding moves the JAX NLML by
-4e-5 and hides most of the float32 model's shift.  Both are valid float32
arithmetic; the port keeps its more accurate sum (an intended departure).
This test pins that account: with yᵀy summed in index order, and nothing
else changed, the port's NLML lands within 1e-5 of the JAX package's loss
evaluated op by op.  Measured at one torch thread, jax 0.9.0, on the CPU.
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
import gp_grief_tpu.models.gp_ski as jski
import gp_grief_tpu_torch.ops.lanczos as tlz
import jax
import jax.numpy as jnp
from tools import ski_f32_gap_jax as gap
from tools import ski_reference_jax as ref

torch.set_num_threads(1)

NAME, M_PTS, N = "ski1m_lattice", 12, 20_000


def _rel(a, b):
    return abs(a - b) / abs(b)


@pytest.fixture
def probes(monkeypatch):
    monkeypatch.setattr(jax.random, "rademacher", ref.NumpyProbes())
    monkeypatch.setattr(jski, "kron_eigh", ref.kron_eigh_canonical)
    monkeypatch.setattr(jski, "top_p_kron_eigs", ref.top_p_kron_eigs_quantized)
    monkeypatch.setattr(tlz, "rademacher", cs.NumpyProbes())
    monkeypatch.setattr(cs, "DEVICE", "cpu")


def test_lattice_f32_nlml_departs_from_jax_by_its_yty_sum(probes):
    x, y, xg = cs.ski_data(NAME, N, M_PTS)  # float32
    jm = ref.model(NAME, x, y, xg)
    jax_nl = -float(jm.log_likelihood())  # jitted, as a user calls it
    jax_eager = gap.jax_terms(jm)  # the same loss op by op
    tm = cs.ski_model(NAME, x, y, xg, torch.float32)
    port_nl = -tm.log_likelihood()
    # The float64 NLML on the same probes (the JAX package's agrees to
    # 1.1e-13: tools/ski_f32_gap_jax.py --config ski1m_lattice --m 12 --n 20000).
    as64 = [a.astype(np.float64) for a in (x, y)]
    tm64 = cs.ski_model(NAME, *as64, [g.astype(np.float64) for g in xg], torch.float64)
    f64_nl = -cs.with_numpy_probes(tm64.log_likelihood)
    # The rebuilt loss is the model's, bit for bit.
    assert gap.port_terms(tm)["nlml"] == port_nl
    swapped = gap.port_terms(tm, sequential_yty=True)
    # The mechanism: the JAX package's float32 dot is the index-order sum.
    y32 = y.astype(np.float32)
    assert jax_eager["yty"] == gap.sequential_dot(y32, y32) == swapped["yty"]
    # The port's float32 NLML: about three times its measured 5.9e-5 from float64.
    assert _rel(port_nl, f64_nl) < 1.8e-4
    # The departure is that one sum: the port as shipped is 5.0e-5 from the
    # JAX NLML.  With the JAX package's summation order it is 3.3e-6 from the
    # JAX loss evaluated op by op: the comparison held to the 1e-5 the swap
    # must meet, since both sides then sum the same terms one op at a time.
    assert _rel(port_nl, jax_nl) > 3e-5
    assert _rel(swapped["nlml"], jax_eager["nlml"]) < 1e-5
    # The jitted loss fuses its reductions and so sums in another order: that
    # alone moves the JAX value by 6.0e-6 from the op-by-op one, which puts
    # the swap 9.3e-6 from it.  Its limit is the 1e-5 above plus that 6.0e-6,
    # rounded up.
    assert _rel(jax_eager["nlml"], jax_nl) < 1e-5
    assert _rel(swapped["nlml"], jax_nl) < 2e-5
