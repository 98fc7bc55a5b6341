"""Polya-Gamma sampler moment identities (SURVEY.md §4: E[w] = b/(2c) tanh(c/2))."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from functionalmf_tpu.ops.polyagamma import pg_mean, pg_var, polya_gamma


@pytest.mark.parametrize("b,c", [(1.0, 0.5), (1.0, 2.0), (3.0, 1.0),
                                 (50.0, 0.1), (200.0, 3.0)])
def test_pg_moments(key, b, c):
    n = 8000
    draws = polya_gamma(key, jnp.full((n,), b), jnp.full((n,), c))
    draws = np.asarray(draws)
    m_true = float(pg_mean(b, c))
    v_true = float(pg_var(b, c))
    assert abs(draws.mean() - m_true) < 5 * np.sqrt(v_true / n) + 1e-4
    # variance: truncation loses a tiny tail; allow 3% + MC error
    assert abs(draws.var() - v_true) < 0.03 * v_true + 6 * v_true * np.sqrt(2.0 / n)


def test_pg_zero_b(key):
    out = polya_gamma(key, jnp.asarray([0.0, 1.0]), jnp.asarray([1.0, 1.0]))
    assert float(out[0]) == 0.0
    assert float(out[1]) > 0.0


def test_pg_c_zero_limit(key):
    # PG(b, 0) has mean b/4
    draws = np.asarray(polya_gamma(key, jnp.full((20000,), 2.0), jnp.zeros(20000)))
    np.testing.assert_allclose(draws.mean(), 0.5, rtol=0.03)


def test_pg_symmetric_in_c(key):
    # PG(b, c) == PG(b, -c) in distribution
    d1 = np.asarray(polya_gamma(key, jnp.full((20000,), 1.0), jnp.full((20000,), 2.0)))
    d2 = np.asarray(polya_gamma(key, jnp.full((20000,), 1.0), jnp.full((20000,), -2.0)))
    assert abs(d1.mean() - d2.mean()) < 0.01


def test_pg_var_small_c_f32():
    """Regression: pg_var must stay accurate (and nonnegative) through the
    sinh(c) - c cancellation zone in f32. The naive form lost all bits
    below |c| ~ 0.01 and went *negative* on an accelerator, NaN-ing the large-b
    normal-approximation draw and silently freezing Binomial/NegBinom
    chains behind the nan_guard (round-2 diagnosis of VERDICT item 10)."""
    cs = np.concatenate([np.logspace(-6, 1, 200), -np.logspace(-6, 1, 200),
                         [0.0]])
    got = np.asarray(pg_var(1.0, jnp.asarray(cs, jnp.float32)))
    # f64 reference via the numerically safe mpmath-free route: series for
    # small |c|, naive form elsewhere (safe in f64 down to ~1e-4)
    c = cs.astype(np.float64)
    safe = np.where(np.abs(c) < 1e-3, 1.0, c)
    ref = np.where(np.abs(c) < 1e-3,
                   (1.0 + c**2 / 20.0) / 24.0,
                   (np.sinh(safe) - safe) / (4.0 * safe**3))
    ref = ref / np.cosh(c / 2.0) ** 2
    assert np.all(got >= 0.0)
    np.testing.assert_allclose(got, ref, rtol=2e-3)


def test_pg_large_b_small_c_finite(key):
    """The exact (b, c) regime that froze NB chains: b > 50 (normal branch)
    with |c| in the old cancellation band."""
    b = jnp.full((1000,), 50.6)
    c = jnp.full((1000,), -0.0117)
    draws = polya_gamma(key, b, c)
    assert bool(jnp.all(jnp.isfinite(draws)))
    m = float(pg_mean(50.6, -0.0117))
    assert abs(float(draws.mean()) - m) < 0.05 * m


def test_pg_jit_vmap(key):
    f = jax.jit(lambda k, b, c: polya_gamma(k, b, c))
    out = f(key, jnp.ones((4, 5)), jnp.zeros((4, 5)))
    assert out.shape == (4, 5)
    assert bool(jnp.all(jnp.isfinite(out)))


# ---------------------------------------------------------------------------
# Distributional (KS) validation against an exact Devroye sampler
# (VERDICT round-2 item 3). Ground truth: tests/pg_exact.py, the
# alternating-series rejection sampler of Polson/Scott/Windle 2013 — the
# same construction as the reference's native pypolyagamma
# (reference functionalmf/factor.py:458-460). All seeds fixed:
# deterministic, no flake.
# ---------------------------------------------------------------------------
from scipy.stats import ks_2samp  # noqa: E402

from tests.pg_exact import exact_pg1, exact_pg  # noqa: E402


def _ks_assert(ours, exact, n_eff, slack=1.0):
    """Assert the two samples agree distributionally: D below the
    alpha=1e-3 two-sample critical value times `slack`."""
    d = ks_2samp(ours, exact).statistic
    crit = 1.949 * np.sqrt(2.0 / n_eff)  # c(1e-3) = sqrt(-ln(5e-4)/2)
    assert d < slack * crit, (d, crit)


@pytest.mark.parametrize("c", [0.1, 1.0, 3.0, 8.0])
def test_pg_ks_exact_b1(c):
    """Whole-distribution agreement of the gamma-sum sampler at b=1 (the
    documented variance deficit at num_terms=16 is ~1e-4 relative — far
    below the KS resolution at this N)."""
    n = 20000
    rng = np.random.default_rng(7)
    exact = exact_pg1(rng, c, n)
    ours = np.asarray(polya_gamma(jax.random.PRNGKey(3), jnp.ones(n),
                                  jnp.full((n,), c)))
    _ks_assert(ours, exact, n)


def test_pg_ks_exact_b4():
    """Integer b: PG(4, 1.5) vs the sum of 4 exact PG(1, 1.5) draws."""
    n = 20000
    rng = np.random.default_rng(11)
    exact = exact_pg(rng, 4, 1.5, n)
    ours = np.asarray(polya_gamma(jax.random.PRNGKey(5), jnp.full((n,), 4.0),
                                  jnp.full((n,), 1.5)))
    _ks_assert(ours, exact, n)


def test_pg_ks_fractional_b():
    """Fractional b (used by the NB model with aggregated pseudo-counts):
    PG(2.5, 1) via the gamma-sum convolution vs exact PG(2, 1) + PG(0.5, 1)
    has no exact ground truth at b=0.5, so check b=2 + b=0.5 additivity
    instead: PG(2.5, c) =d PG(2, c) + PG(0.5, c) by construction of the
    family. Draw both sides from OUR sampler with independent keys — this
    verifies the convolution property the augmentation relies on."""
    n = 20000
    c = 1.0
    lhs = np.asarray(polya_gamma(jax.random.PRNGKey(8), jnp.full((n,), 2.5),
                                 jnp.full((n,), c)))
    a = np.asarray(polya_gamma(jax.random.PRNGKey(9), jnp.full((n,), 2.0),
                               jnp.full((n,), c)))
    b = np.asarray(polya_gamma(jax.random.PRNGKey(10), jnp.full((n,), 0.5),
                               jnp.full((n,), c)))
    _ks_assert(lhs, a + b, n)


@pytest.mark.slow
@pytest.mark.parametrize("b", [49.0, 50.0, 64.0])
def test_pg_ks_normal_threshold_neighborhood(b):
    """The b ~ normal_approx_above=50 crossover: b=49 is the last gamma-sum
    case, b=50 the first normal-branch case, b=64 the worst measured KS in
    a threshold scan (0.036 at c=0.5, at the alpha=0.01 critical value —
    the CLT skew O(b^-1/2) ~ 0.13 is the dominant error there and decays
    with b). Ground truth: sums of b exact PG(1, c) draws."""
    n = 4000
    rng = np.random.default_rng(13)
    for c in (0.5, 2.0):
        exact = exact_pg(rng, int(b), c, n)
        ours = np.asarray(polya_gamma(jax.random.PRNGKey(int(b) * 7 + int(c * 10)),
                                      jnp.full((n,), b), jnp.full((n,), c)))
        _ks_assert(ours, exact, n)


@pytest.mark.slow
def test_pg_ks_normal_branch_b500():
    """The politics regime (factor.py:553 makes b = sum(Y + R), data max
    461): b=500 routes through the moment-matched normal branch. Ground
    truth: sums of 500 exact PG(1, c) draws. The CLT skew at b=500 is
    O(b^-1/2) ~ 0.045, well below the KS critical value at this N."""
    n = 4000
    rng = np.random.default_rng(13)
    for c in (0.5, 2.0):
        exact = exact_pg(rng, 500, c, n)
        ours = np.asarray(polya_gamma(jax.random.PRNGKey(17),
                                      jnp.full((n,), 500.0),
                                      jnp.full((n,), c)))
        _ks_assert(ours, exact, n)


def test_exact_sampler_self_moments():
    """The ground-truth sampler itself must match the closed-form moments
    (guards the test harness, not the library)."""
    rng = np.random.default_rng(21)
    for c in (0.0, 1.0, 4.0):
        d = exact_pg1(rng, c, 100000)
        m, v = float(pg_mean(1.0, c)), float(pg_var(1.0, c))
        assert abs(d.mean() - m) < 4.5 * np.sqrt(v / len(d))
        assert abs(d.var() - v) < 0.02 * v
