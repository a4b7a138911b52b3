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
the exact yᵀy; the port's, summed in float64 with quad's other two sums
(``models.gp_ski._dual_quad``), is exact to float32.  quad cancels yᵀy down
to 1/127 of itself and divides by σ² = 0.05, so that rounding moves the JAX
NLML by -4e-5 and hides most of the float32 model's shift.  Both are valid float32
arithmetic; the port keeps its more accurate sum (an intended departure).
This test pins that account: with yᵀy summed in index order, and nothing
else changed, the port's NLML lands within 1e-5 of the JAX package's loss
evaluated op by op.  Measured at one torch thread, jax 0.9.0, on the CPU.
"""

import math

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
    # The departure is that one sum: the port as shipped is 4.9e-5 from the
    # JAX NLML.  With the JAX package's summation order it is 1.9e-6 from the
    # JAX loss evaluated op by op: the comparison held to the 1e-5 the swap
    # must meet, since both sides then sum the same terms one op at a time
    # (the port's other two sums in float64, the JAX package's in float32).
    assert _rel(port_nl, jax_nl) > 3e-5
    assert _rel(swapped["nlml"], jax_eager["nlml"]) < 1e-5
    # The jitted loss fuses its reductions and so sums in another order: that
    # alone moves the JAX value by 6.0e-6 from the op-by-op one, which puts
    # the swap 7.9e-6 from it.  Its limit is the 1e-5 above plus that 6.0e-6,
    # rounded up.
    assert _rel(jax_eager["nlml"], jax_nl) < 1e-5
    assert _rel(swapped["nlml"], jax_nl) < 2e-5


def test_dual_quad_is_the_jax_quad_summed_in_float64():
    """``models.gp_ski._dual_quad`` against the JAX package's float32 quad
    (``gp_grief_tpu/models/gp_ski.py:601-604``) on float32 vectors that
    cancel as ski1m_lattice's do (quad ≈ 1/127 of yᵀy, σ² = 0.05): the port's
    is the float64 value rounded once to float32, and the JAX package's is
    within its three float32 sums' rounding of it.  The port's float64
    accumulation is an intended departure (ROADMAP); this pins its size."""
    from gp_grief_tpu_torch.models.gp_ski import _dual_quad

    rng = np.random.default_rng(11)
    n, sigma2 = 1 << 20, 0.05
    y = rng.standard_normal(n).astype(np.float32)
    gam = (0.911 * y + 0.01 * rng.standard_normal(n)).astype(np.float32)
    vt = (y + 0.01 * rng.standard_normal(n)).astype(np.float32)
    d = (1.0 + 0.001 * rng.standard_normal(n)).astype(np.float32)
    wg = gam * d  # W̃γ for a diagonal W̃, as float32
    exact = (np.dot(y.astype(np.float64), y) - 2.0 * np.dot(vt.astype(np.float64), gam)
             + np.dot(gam.astype(np.float64), wg)) / sigma2
    jy, jv, jg, jd = (jnp.asarray(a) for a in (y, vt, gam, d))
    jax_quad = float((jnp.dot(jy, jy) - 2.0 * jnp.dot(jv, jg) + jnp.dot(jg, jg * jd)) / sigma2)
    ty, tv, tg, td = (torch.from_numpy(a) for a in (y, vt, gam, d))
    port = _dual_quad(torch.dot(ty.double(), ty.double()), tv, tg, lambda t: t * td, sigma2)
    assert port.dtype == torch.float32
    yty = float(np.dot(y.astype(np.float64), y)) / sigma2
    assert 100 < yty / exact < 150  # it cancels to about 1/127, as ski1m_lattice's
    ulp = float(np.spacing(np.float32(exact)))
    assert abs(float(port) - exact) <= ulp
    # The JAX quad's float32 sums (index order on the CPU) land 129·eps of
    # their absolute sums S from the float64 value here (47-129 over seeds
    # 11-13); a random walk of n roundings bounds that by sqrt(n)·eps·S.
    eps = float(np.finfo(np.float32).eps)
    S = float(np.dot(np.abs(y), np.abs(y)) + 2 * np.dot(np.abs(vt), np.abs(gam))
              + np.dot(np.abs(gam), np.abs(wg))) / sigma2
    assert abs(jax_quad - exact) <= math.sqrt(n) * eps * S
    # So the port departs from the JAX quad by exactly the JAX sums' rounding.
    assert abs(abs(float(port) - jax_quad) - abs(jax_quad - exact)) <= ulp
