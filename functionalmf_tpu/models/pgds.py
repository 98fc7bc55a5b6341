"""Poisson-Gamma Dynamical Systems (PGDS) — JAX Gibbs sampler.

The reference uses PGDS (Schein, Wallach & Zhou, NeurIPS 2016) as its
comparison baseline and NMF warm-start source, consumed through the
external Cython `apf` package (reference functionalmf/pgds.py:17,
politics/benchmark.py:74-81, examples/poisson_tensor_filtering.py
PGDS arms). This module is an independent, from-the-paper implementation
so the baseline runs without `apf`: static shapes, one jitted sweep,
`lax.scan` over time and over sweeps, counter-based keys.

Model (3-tensor Y[i, j, t], time is the last axis, K components):

    y_ijt ~ Pois(delta_t * sum_k a_ik b_jk theta_tk)      observed cells
    a_:k ~ Dir(eps 1_N),  b_:k ~ Dir(eps 1_M)             (columns sum 1)
    theta_1k ~ Gam(tau nu_k, tau)
    theta_tk ~ Gam(tau (Pi theta_{t-1})_k, tau)           gamma-Markov
    Pi columns: pi_:k ~ Dir(nu_1 nu_k, ..., xi nu_k [diag], ..., nu_K nu_k)
    delta_t ~ Gam(eps, eps)  per step   (stationary=False)
    delta   ~ Gam(eps, eps)  shared     (stationary=True)
    nu_k ~ Gam(gam/K, beta), xi ~ Gam(eps, beta), beta ~ Gam(eps, eps)

Gibbs sweep (paper section 4):

  0. Impute missing cells: y_miss ~ Pois(current rate). This is apf's
     `impute_after=0` behavior (the reference wrapper requests it,
     pgds.py:60) and is what keeps the normalized factor columns exactly
     Dirichlet-conjugate — with incomplete exposure the Poisson
     normalizer would depend on the factors through the mask.
  1. Allocate y_ijt over k (multinomial, ops/crt.multinomial_split).
  2. a, b columns: Dirichlet-conjugate in the allocated counts.
  3. Backward pass t = T..2: l_tk ~ CRT(m_tk, tau (Pi theta_{t-1})_k)
     with m_tk = y_tk + (splits arriving from t+1); each l_tk is split
     over source components k2 with weights pi_kk2 theta_{t-1,k2}. The
     future-evidence rate rho follows the paper's zeta recursion
     (kept per-component; with complete data it collapses to the
     paper's scalar zeta because Pi's columns sum to one):
         rho_{t-1,k2} = tau sum_k1 pi_k1k2 ln(1 + (delta_t
                                                   + rho_tk1)/tau)
  4. Forward pass t = 1..T: theta_tk ~ Gam(m_tk + tau (Pi theta_{t-1})_k,
     tau + delta_t + rho_tk)   (tau nu_k at t = 1).
  5. Pi columns: Dirichlet-conjugate in the accumulated splits H.
  6. delta: Gamma-conjugate (per-t or shared).
  7. (nu, xi): joint random-walk MH in log space on their exact
     conditionals; beta: Gamma-conjugate given (nu, xi). The paper uses
     a deeper compound-CRT ladder for these K+1 scalars; an MH step on
     the same conditionals targets the identical posterior and is the
     whole of the deviation from the paper's scheme.

Binary mode (Bernoulli-Poisson link, apf's `binary=True`): y in {0,1}
observed as 1[n > 0]; latent n drawn per sweep from the zero-truncated
Poisson at the current rate, then the count machinery runs on n.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.scipy.special import gammaln

from functionalmf_tpu.ops.crt import chinese_restaurant_table, \
    multinomial_split

__all__ = ["pgds_gibbs"]


def _ztp(key, lam, y, max_n: int = 64):
    """Zero-truncated Poisson draws where y == 1, else 0 (binary mode)."""
    lam = jnp.clip(lam, 1e-6, None)
    u = jax.random.uniform(key, lam.shape)
    # invert the ZTP cdf by a bounded scan: P(n) ∝ lam^n / n!, n >= 1
    logp1 = jnp.log(lam) - lam - jnp.log1p(-jnp.exp(-lam))

    def step(carry, n):
        cdf, logp, out = carry
        take = (u > cdf) & (out == 0)
        cdf2 = cdf + jnp.exp(logp)
        out2 = jnp.where((u <= cdf2) & (out == 0), n, out)
        logp2 = logp + jnp.log(lam) - jnp.log(n + 1.0)
        return (cdf2, logp2, out2), None

    (_, _, n), _ = jax.lax.scan(
        step, (jnp.zeros_like(lam), logp1, jnp.zeros_like(lam)),
        jnp.arange(1, max_n + 1, dtype=jnp.float32))
    n = jnp.where(n == 0, jnp.ceil(lam), n)     # overflow guard: modal tail
    return jnp.where(y > 0, n, 0.0)


def _log_dir(p, a):
    return (gammaln(a.sum(-1)) - gammaln(a).sum(-1)
            + ((a - 1.0) * jnp.log(jnp.clip(p, 1e-30, None))).sum(-1))


def _pi_alpha(nu, xi):
    """Dirichlet concentration for Pi's columns: nu_k1 nu_k2, xi nu_k2 diag."""
    A = nu[:, None] * nu[None, :]
    return A.at[jnp.diag_indices(nu.shape[0])].set(xi * nu)


def _hyper_logpost(nu, xi, theta1, Pi, tau, gam, eps, beta):
    K = nu.shape[0]
    lp = ((gam / K - 1.0) * jnp.log(nu) - beta * nu).sum()
    lp += (eps - 1.0) * jnp.log(xi) - beta * xi
    a = tau * nu
    lp += (a * jnp.log(tau) - gammaln(a)
           + (a - 1.0) * jnp.log(jnp.clip(theta1, 1e-30, None))
           - tau * theta1).sum()
    alpha = _pi_alpha(nu, xi)
    lp += _log_dir(Pi.T, alpha.T).sum()        # columns of Pi
    return lp


def pgds_gibbs(Y, nembeds, *, gam=10.0, tau=1.0, eps=0.1,
               stationary=False, binary=False,
               nburn=5000, nthin=10, nsamples=500, seed=42,
               verbose=0, n_mh=3, mh_step=0.08, chunk_sweeps=500):
    """Run the PGDS Gibbs sampler on a 3-tensor (time = last axis).

    Returns dict of draws: A (S,N,K), B (S,M,K), Theta (S,T,K),
    delta (S,T), plus `mean_rate(draw)` reconstruction helper inputs.
    Mirrors reference pgds.py:19-70's burn/thin/sample protocol.
    """
    Y = np.asarray(Y, np.float32)
    assert Y.ndim == 3, "PGDS expects a 3-tensor with time last"
    N, M, T = Y.shape
    K = int(nembeds)
    mask = np.isfinite(Y)
    Y0 = np.where(mask, np.nan_to_num(Y), 0.0).astype(np.float32)
    maskf = mask.astype(np.float32)
    gam, tau, eps = float(gam), float(tau), float(eps)

    key = jax.random.PRNGKey(seed)
    k0, key = jax.random.split(key)
    ks = jax.random.split(k0, 6)
    state = dict(
        A=jnp.asarray(np.full((N, K), 1.0 / N, np.float32)),
        B=jnp.asarray(np.full((M, K), 1.0 / M, np.float32)),
        Theta=jax.random.gamma(ks[0], 1.0, (T, K)).astype(jnp.float32),
        Pi=jnp.full((K, K), 1.0 / K, jnp.float32),
        delta=jnp.full((T,), max(Y0.sum() / max(maskf.sum(), 1.0), 0.1),
                       jnp.float32),
        nu=jnp.ones((K,), jnp.float32),
        xi=jnp.asarray(1.0, jnp.float32),
        beta=jnp.asarray(1.0, jnp.float32),
    )
    Yd = jnp.asarray(Y0)
    Md = jnp.asarray(maskf)

    def rate_of(s):
        r = jnp.einsum("ik,jk,tk->ijt", s["A"], s["B"],
                       s["Theta"] * s["delta"][:, None])
        return r

    def sweep(s, key):
        keys = jax.random.split(key, 12)
        # -- 0. impute missing cells (+ binary latents) ------------------
        lam = rate_of(s)
        Ymiss = jax.random.poisson(keys[9], jnp.clip(lam, 1e-10, None)
                                   ).astype(jnp.float32)
        if binary:
            Yobs = _ztp(keys[11], lam, Yd)
        else:
            Yobs = Yd
        Yc = jnp.where(Md > 0, Yobs, Ymiss)
        # -- 1. allocation ------------------------------------------------
        R = jnp.einsum("ik,jk,tk->ijtk", s["A"], s["B"], s["Theta"])
        P = R / jnp.clip(R.sum(-1, keepdims=True), 1e-30, None)
        C = multinomial_split(keys[0], Yc, P)              # (N,M,T,K)
        A_cnt = C.sum(axis=(1, 2))
        B_cnt = C.sum(axis=(0, 2))
        Y_tk = C.sum(axis=(0, 1))                          # (T,K)
        # -- 2. factor columns ---------------------------------------------
        A = jax.random.dirichlet(keys[1], eps + A_cnt.T).T.astype(jnp.float32)
        B = jax.random.dirichlet(keys[2], eps + B_cnt.T).T.astype(jnp.float32)
        A = jnp.clip(A, 1e-20, None)
        B = jnp.clip(B, 1e-20, None)
        # -- 3. backward pass ----------------------------------------------
        Pi, Theta, delta = s["Pi"], s["Theta"], s["delta"]
        bkeys = jax.random.split(keys[3], T)

        def back(carry, inp):
            lp_next, rho_next = carry                      # (K,), (K,)
            y_t, th_prev, d_t, kk = inp                    # at time t
            m_t = y_t + lp_next
            pth = Pi @ th_prev                             # (K,)
            k1, k2 = jax.random.split(kk)
            l_t = chinese_restaurant_table(k1, m_t, tau * pth)
            w = Pi * th_prev[None, :]                      # (K,K) row k
            wp = w / jnp.clip(w.sum(-1, keepdims=True), 1e-30, None)
            h_t = multinomial_split(k2, l_t, wp)           # (K,K)
            lp_prev = h_t.sum(0)                           # arriving at t-1
            rho_prev = tau * (Pi.T @ jnp.log1p((d_t + rho_next) / tau))
            return (lp_prev, rho_prev), (m_t, rho_next, h_t)

        # iterate t = T-1 .. 1 (python index), inputs reversed
        inp = (Y_tk[1:][::-1], Theta[:-1][::-1], delta[1:][::-1],
               bkeys[1:][::-1])
        (lp0, rho0), (m_rev, rho_rev, h_rev) = jax.lax.scan(
            back, (jnp.zeros(K), jnp.zeros(K)), inp)
        m = jnp.concatenate([(Y_tk[0] + lp0)[None], m_rev[::-1]], 0)  # (T,K)
        rho = jnp.concatenate([rho0[None], rho_rev[::-1]], 0)         # (T,K)
        H = h_rev.sum(0)                                              # (K,K)
        # -- 4. forward theta ----------------------------------------------
        fkeys = jax.random.split(keys[4], T)

        def fwd(th_prev, inp):
            m_t, rho_t, d_t, kk, is0 = inp
            shape = m_t + tau * jnp.where(is0, s["nu"], Pi @ th_prev)
            rt = tau + d_t + rho_t
            th = jax.random.gamma(kk, jnp.clip(shape, 1e-6, None)) / rt
            th = jnp.clip(th, 1e-20, None)
            return th, th

        is0 = jnp.zeros((T,), bool).at[0].set(True)
        _, Theta_new = jax.lax.scan(
            fwd, jnp.zeros(K), (m, rho, delta, fkeys, is0))
        # -- 5. Pi columns -------------------------------------------------
        alpha = _pi_alpha(s["nu"], s["xi"])
        Pi_new = jax.random.dirichlet(
            keys[5], (alpha + H).T).T.astype(jnp.float32)
        Pi_new = jnp.clip(Pi_new, 1e-20, None)
        # -- 6. delta ------------------------------------------------------
        ts = Theta_new.sum(-1)                             # (T,)
        yt = Y_tk.sum(-1)
        if stationary:
            d = jax.random.gamma(keys[6], eps + yt.sum()) / (eps + ts.sum())
            delta_new = jnp.full((T,), d)
        else:
            delta_new = (jax.random.gamma(keys[6], eps + yt)
                         / (eps + ts))
        delta_new = jnp.clip(delta_new, 1e-10, None)
        # -- 7. hyperpriors: (nu, xi) joint log-space MH, beta conjugate --
        nu, xi = s["nu"], s["xi"]
        th1 = Theta_new[0]

        def mh(carry, kk):
            nu_c, xi_c = carry
            k1, k2 = jax.random.split(kk)
            z = jax.random.normal(k1, (K + 1,)) * mh_step
            nu_p = nu_c * jnp.exp(z[:K])
            xi_p = xi_c * jnp.exp(z[K])
            lp_c = _hyper_logpost(nu_c, xi_c, th1, Pi_new, tau, gam, eps,
                                  s["beta"]) + jnp.log(nu_c).sum() \
                + jnp.log(xi_c)
            lp_p = _hyper_logpost(nu_p, xi_p, th1, Pi_new, tau, gam, eps,
                                  s["beta"]) + jnp.log(nu_p).sum() \
                + jnp.log(xi_p)
            acc = jnp.log(jax.random.uniform(k2)) < (lp_p - lp_c)
            return (jnp.where(acc, nu_p, nu_c),
                    jnp.where(acc, xi_p, xi_c)), None

        (nu_new, xi_new), _ = jax.lax.scan(
            mh, (nu, xi), jax.random.split(keys[7], n_mh))
        beta_new = (jax.random.gamma(keys[8], eps + gam + eps)
                    / (eps + nu_new.sum() + xi_new))
        return dict(A=A, B=B, Theta=Theta_new, Pi=Pi_new, delta=delta_new,
                    nu=nu_new, xi=xi_new, beta=beta_new)

    @jax.jit
    def run_chunk(state, key, nsteps_arr):
        def body(carry, kk):
            return sweep(carry, kk), None
        keys = jax.random.split(key, nsteps_arr.shape[0])
        state, _ = jax.lax.scan(body, state, keys)
        return state

    @jax.jit
    def collect(state, thin_keys):
        def body(st, kks):                     # kks: (nthin,) keys
            def inner(c, k2):
                return sweep(c, k2), None
            st, _ = jax.lax.scan(inner, st, kks)
            return st, (st["A"], st["B"], st["Theta"], st["delta"])
        state, draws = jax.lax.scan(body, state, thin_keys)
        return state, draws

    # Bound every device execution to ~chunk_sweeps sweeps: one giant
    # nburn-long scan would be a single multi-minute XLA execution.
    kb, kc = jax.random.split(key)
    nthin = max(nthin, 1)
    chunk = max(int(chunk_sweeps), nthin)
    nfull, nrem = divmod(max(nburn, 1), chunk)
    bkeys = jax.random.split(kb, nfull + 1)
    zfull = jnp.zeros((chunk,))
    for i in range(nfull):
        state = jax.block_until_ready(run_chunk(state, bkeys[i], zfull))
        if verbose:
            print("PGDS: burn {}/{}".format((i + 1) * chunk, nburn))
    if nrem:
        state = jax.block_until_ready(
            run_chunk(state, bkeys[nfull], jnp.zeros((nrem,))))
    draws_per_chunk = max(chunk // nthin, 1)
    acc = dict(A=[], B=[], Theta=[], delta=[])
    done = 0
    while done < nsamples:
        take = min(draws_per_chunk, nsamples - done)
        kc, kt = jax.random.split(kc)
        thin_keys = jax.random.split(kt, take * nthin)
        thin_keys = thin_keys.reshape((take, nthin) + thin_keys.shape[1:])
        state, (As, Bs, Ths, Ds) = collect(state, thin_keys)
        jax.block_until_ready(state)
        for name, arr in zip(("A", "B", "Theta", "delta"),
                             (As, Bs, Ths, Ds)):
            acc[name].append(np.asarray(arr))
        done += take
        if verbose:
            print("PGDS: collected {}/{} draws".format(done, nsamples))
    return {name: np.concatenate(parts, axis=0)
            for name, parts in acc.items()}
