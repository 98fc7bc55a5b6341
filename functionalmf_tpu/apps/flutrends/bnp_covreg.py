"""Bayesian nonparametric covariance regression (Fox & Dunson, JMLR 2015).

JAX reimplementation of the reference's vendored MATLAB baseline
(flutrends/BNP_covreg_varinds.m:1-616, driven by
flutrends/runstuff_varinds_flu_states.m:1-204): the comparison arm of the
Google Flu Trends benchmark (flutrends/benchmark.py:146-152). The model is

    y_n = Theta zeta(x_n) eta_n + eps_n,   eps_n ~ N(0, diag(1/invSig))
    eta_n = psi(x_n) + xi_n,               xi_n  ~ N(0, I_k)

with each scalar dictionary function zeta_{l,k}(.) and latent-mean
function psi_k(.) an independent GP over the predictor grid (squared
exponential kernel), Theta (p x L) under a multiplicative-gamma-process
shrinkage prior (phi, tau), and missing observations handled by masking
(the "varinds" variant). Predictive mean mu(x_n) = Theta zeta_n psi_n and
covariance Theta zeta_n zeta_n' Theta' + diag(1/invSig)
(runstuff_varinds_flu_states.m:140-145).

Deliberate deviations from the MATLAB (documented, not bugs):

- **No explicit inv(K).** The MATLAB forms invK once (condition ~d/r =
  1e5 for the flu settings) and Cholesky-factors invK + diag(A) per GP
  update — fine in float64, garbage in float32. We never form invK:
  each conditional N(Sig*h, Sig) with Sig = (invK + diag(A))^{-1} is
  sampled by the noise-aware pathwise (Matheron) rule through
  B = S K S + I (S = sqrt(A)), which is well-conditioned by
  construction, so the whole sampler runs in float32 on the device.
  Distributional equivalence is tested against the dense float64
  information form (tests/test_bnp_covreg.py).
- **Sane missingness mask.** The MATLAB runner's start_dates loop
  (runstuff_varinds_flu_states.m:28-38) counts *all* NaNs of a series,
  then drops that many *leading* weeks — an indexing bug that masks a
  few extra observed entries. We mask exactly the missing entries.
- **Per-coordinate predictive draws.** The runner simulates full MVN
  y-samples per stored draw only to take per-coordinate intervals
  (runstuff:147-149, 169-171); marginals need only the covariance
  diagonal, which we store directly.
"""
from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax.scipy.linalg import cho_solve, solve_triangular


def se_kernel(N, c=100.0, d=1.0, r=1e-5):
    """Squared-exponential GP kernel on the grid x = (1..N)/N
    (runstuff_varinds_flu_states.m:70-81)."""
    x = (np.arange(1, N + 1) / N)[:, None]
    K = d * np.exp(-c * (x - x.T) ** 2)
    return K + r * np.eye(N)


def _sample_gp_conditional(key, A, h, K, cholK):
    """Draw from N(Sig h, Sig), Sig = (inv(K) + diag(A))^{-1}, A >= 0.

    Pathwise form: f = f0 + K S B^{-1} (h/S - S f0 - z),
    B = S K S + I, S = sqrt(A), f0 ~ N(0, K), z ~ N(0, I). Entries with
    A = 0 carry h = 0 in every caller (no observation), so h/S := 0.
    Replaces the MATLAB's chol(invK + diag(A)) information form
    (BNP_covreg_varinds.m:341-346) without ever forming invK.
    """
    N = A.shape[0]
    k1, k2 = jax.random.split(key)
    f0 = cholK @ jax.random.normal(k1, (N,), K.dtype)
    z = jax.random.normal(k2, (N,), K.dtype)
    S = jnp.sqrt(A)
    B = S[:, None] * K * S[None, :] + jnp.eye(N, dtype=K.dtype)
    F = jnp.linalg.cholesky(B)
    hS = jnp.where(A > 0, h / jnp.maximum(S, jnp.finfo(K.dtype).tiny), 0.0)
    return f0 + K @ (S * cho_solve((F, True), hS - S * f0 - z))


def _sample_zeta(key, state, y, inds, K, cholK, L, k):
    """Sequential per-(l,k) GP updates of the dictionary functions with
    residual bookkeeping (BNP_covreg_varinds.m:245-353)."""
    theta, zeta, invSig = state["theta"], state["zeta"], state["invSig"]
    eta = state["psi"] + state["xi"]                     # (k, N)
    invSigM = invSig[:, None] * inds                     # (p, N)
    w = jnp.einsum("pl,pn->ln", theta ** 2, invSigM)     # (L, N)
    tiv = theta * invSig[:, None]                        # (p, L)

    kperm, kscan = jax.random.split(key)
    # random kk order within each row ll (BNP_covreg_varinds.m:324)
    perms = jax.vmap(lambda kk: jax.random.permutation(kk, k))(
        jax.random.split(kperm, L))                      # (L, k)
    lls = jnp.repeat(jnp.arange(L), k)
    kks = perms.reshape(-1)

    mu_tot = jnp.einsum("pl,lkn,kn->pn", theta, zeta, eta)

    def step(carry, inp):
        zeta, mu_tot = carry
        ll, kk, kstep = inp
        zlk = zeta[ll, kk]                               # (N,)
        contrib = theta[:, ll, None] * (eta[kk] * zlk)[None, :]
        mu_tot = mu_tot - contrib
        A = eta[kk] ** 2 * w[ll]
        ytilde = (y - mu_tot) * inds
        h = eta[kk] * (tiv[:, ll] @ ytilde)
        znew = _sample_gp_conditional(kstep, A, h, K, cholK)
        zeta = zeta.at[ll, kk].set(znew)
        mu_tot = mu_tot + theta[:, ll, None] * (eta[kk] * znew)[None, :]
        return (zeta, mu_tot), None

    keys = jax.random.split(kscan, L * k)
    (zeta, _), _ = jax.lax.scan(step, (zeta, mu_tot), (lls, kks, keys))
    return zeta


def _sample_psi(key, state, y, inds, K, cholK, k, niters):
    """Latent-mean GP updates marginalizing xi, sequential over components
    (BNP_covreg_varinds.m:357-416)."""
    theta, zeta, psi, invSig = (state["theta"], state["zeta"],
                                state["psi"], state["invSig"])
    p = y.shape[0]
    # Omega_n = Theta zeta_n with missing rows zeroed (varinds masking)
    Omega = jnp.einsum("pl,lkn->pkn", theta, zeta) * inds[:, None, :]
    d = jnp.where(inds > 0, 1.0 / invSig[:, None], 1.0)  # (p, N)
    M = jnp.einsum("pkn,qkn->npq", Omega, Omega) + \
        jax.vmap(jnp.diag)(d.T)                          # (N, p, p)
    FM = jnp.linalg.cholesky(M)
    # OIOOS[k2, p2, n] = [Omega_n' M_n^{-1}]_{k2, p2}
    X = cho_solve((FM, True), Omega.transpose(2, 0, 1))  # (N, p, k)
    OIOOS = X.transpose(2, 1, 0)                         # (k, p, N)

    mu_tot = jnp.einsum("pkn,kn->pn", Omega, psi)

    def step(carry, inp):
        psi, mu_tot = carry
        kk, kstep = inp
        Om_k = Omega[:, kk, :]                           # (p, N)
        mu_tot = mu_tot - Om_k * psi[kk][None, :]
        h = jnp.einsum("pn,pn->n", OIOOS[kk], y - mu_tot)
        A = jnp.einsum("pn,pn->n", OIOOS[kk], Om_k)
        pnew = _sample_gp_conditional(kstep, A, h, K, cholK)
        psi = psi.at[kk].set(pnew)
        mu_tot = mu_tot + Om_k * pnew[None, :]
        return (psi, mu_tot), None

    kperm, kscan = jax.random.split(key)
    perms = jax.vmap(lambda kk: jax.random.permutation(kk, k))(
        jax.random.split(kperm, niters)).reshape(-1)     # (niters*k,)
    keys = jax.random.split(kscan, niters * k)
    (psi, _), _ = jax.lax.scan(step, (psi, mu_tot), (perms, keys))
    return psi


def _sample_xi(key, state, y, inds):
    """Latent factor draws, one k-dim Gaussian per time point
    (BNP_covreg_varinds.m:419-443)."""
    theta, zeta, psi, invSig = (state["theta"], state["zeta"],
                                state["psi"], state["invSig"])
    k = psi.shape[0]
    Z = jnp.einsum("pl,lkn->npk", theta, zeta)           # (N, p, k)
    iS = (invSig[:, None] * inds).T                      # (N, p)
    yt = (y - jnp.einsum("npk,kn->pn", Z, psi)).T        # (N, p)

    def one(zn, isn, ytn, kn):
        ZtS = zn.T * isn[None, :]                        # (k, p)
        G = jnp.eye(k, dtype=zn.dtype) + ZtS @ zn
        F = jnp.linalg.cholesky(G)
        m = cho_solve((F, True), ZtS @ ytn)
        zdraw = jax.random.normal(kn, (k,), zn.dtype)
        return m + solve_triangular(F.T, zdraw, lower=False)

    keys = jax.random.split(key, y.shape[1])
    return jax.vmap(one)(Z, iS, yt, keys).T              # (k, N)


def _sample_theta(key, state, y, inds):
    """Weightings-matrix rows under the MGP prior
    (BNP_covreg_varinds.m:446-466)."""
    zeta, invSig, phi = state["zeta"], state["invSig"], state["phi"]
    tau = jnp.exp(jnp.cumsum(jnp.log(state["delta"])))
    eta = state["psi"] + state["xi"]
    L = zeta.shape[0]
    et = jnp.einsum("lkn,kn->nl", zeta, eta)             # (N, L)

    def one(phip, isp, mask, yp, kp):
        etp = et * mask[:, None]
        P = jnp.diag(phip * tau) + isp * (etp.T @ etp)
        F = jnp.linalg.cholesky(P)
        m = isp * cho_solve((F, True), etp.T @ yp)
        zdraw = jax.random.normal(kp, (L,), et.dtype)
        return m + solve_triangular(F.T, zdraw, lower=False)

    keys = jax.random.split(key, y.shape[0])
    return jax.vmap(one)(phi, invSig, inds, y, keys)


def _sample_invSig(key, state, y, inds, a_sig, b_sig):
    """Per-coordinate noise precisions (BNP_covreg_varinds.m:469-488)."""
    theta, zeta = state["theta"], state["zeta"]
    eta = state["psi"] + state["xi"]
    resid = (y - jnp.einsum("pl,lkn,kn->pn", theta, zeta, eta)) * inds
    shape = a_sig + 0.5 * inds.sum(axis=1)
    rate = b_sig + 0.5 * (resid ** 2).sum(axis=1)
    return jax.random.gamma(key, shape) / rate


def _sample_hypers(key, state, a_phi, b_phi, a1, a2, ninner=50):
    """MGP shrinkage hyperparameters phi, delta
    (BNP_covreg_varinds.m:491-518)."""
    theta, phi, delta = state["theta"], state["phi"], state["delta"]
    p, L = theta.shape
    a = jnp.concatenate([jnp.array([a1], theta.dtype),
                         jnp.full((L - 1,), a2, theta.dtype)])
    th2 = theta ** 2

    def outer(carry, kiter):
        phi, delta = carry
        k1, k2 = jax.random.split(kiter)
        tau = jnp.exp(jnp.cumsum(jnp.log(delta)))
        phi = jax.random.gamma(k1, a_phi + 0.5 * jnp.ones_like(phi)) / \
            (b_phi + 0.5 * tau[None, :] * th2)
        spt = (phi * th2).sum(axis=0)                    # (L,)

        def inner(delta, inp):
            hh, kh = inp
            tau_full = jnp.exp(jnp.cumsum(jnp.log(delta)))
            tau_hh = jnp.where(jnp.arange(L) >= hh, tau_full / delta[hh], 0.0)
            shape = a[hh] + 0.5 * p * (L - hh)
            rate = 1.0 + 0.5 * (tau_hh * spt).sum()
            dnew = jax.random.gamma(kh, shape) / rate
            return delta.at[hh].set(dnew), None

        khs = jax.random.split(k2, L)
        delta, _ = jax.lax.scan(inner, delta, (jnp.arange(L), khs))
        return (phi, delta), None

    keys = jax.random.split(key, ninner)
    (phi, delta), _ = jax.lax.scan(outer, (phi, delta), keys)
    return phi, delta


def _gibbs_iter(key, state, y, inds, K, cholK, L, k, hp, psi_iters,
                latent_mean=True):
    """One full Gibbs sweep in the MATLAB's update order
    (BNP_covreg_varinds.m:139-190)."""
    ks = jax.random.split(key, 6)
    state = dict(state)
    state["invSig"] = _sample_invSig(ks[0], state, y, inds,
                                     hp["a_sig"], hp["b_sig"])
    state["phi"], state["delta"] = _sample_hypers(
        ks[1], state, hp["a_phi"], hp["b_phi"], hp["a1"], hp["a2"])
    state["theta"] = _sample_theta(ks[2], state, y, inds)
    if latent_mean:
        state["psi"] = _sample_psi(ks[3], state, y, inds, K, cholK, k,
                                   psi_iters)
    state["xi"] = _sample_xi(ks[4], state, y, inds)
    state["zeta"] = _sample_zeta(ks[5], state, y, inds, K, cholK, L, k)
    return state


def _mu_and_vardiag(state):
    theta, zeta, invSig = state["theta"], state["zeta"], state["invSig"]
    tz = jnp.einsum("pl,lkn->pkn", theta, zeta)
    mu = jnp.einsum("pkn,kn->pn", tz, state["psi"])
    vdiag = (tz ** 2).sum(axis=1) + 1.0 / invSig[:, None]
    return mu, vdiag


def fit_bnp_covreg(y, inds=None, L=10, k=20, niter=10000, store_every=10,
                   nburn=0, c=100.0, d=1.0, r=1e-5, a_sig=1.0, b_sig=0.1,
                   a_phi=1.5, b_phi=1.5, a1=10.0, a2=10.0, seed=0,
                   latent_mean=True, chunk=50, dtype=jnp.float32,
                   verbose=False):
    """Run the BNP-CovReg Gibbs sampler; returns posterior mu / var-diag
    draws. Defaults are the flu runner's settings
    (runstuff_varinds_flu_states.m:83-104: L=10, k=20, Niter=10000,
    storeEvery=10, saveMin=1 i.e. no burn-in).

    y: (p, N) data, NaN where missing (or pass an explicit inds mask).
    Returns {'mu': (S, p, N), 'var_diag': (S, p, N), 'state': pytree}.
    """
    y = np.asarray(y, np.float64)
    if inds is None:
        inds = ~np.isnan(y)
    inds = np.asarray(inds, bool)
    y = np.where(inds, y, 0.0)
    p, N = y.shape

    K = se_kernel(N, c=c, d=d, r=r)
    cholK = np.linalg.cholesky(K)  # float64 on host, cast once
    Kd = jnp.asarray(K, dtype)
    cholKd = jnp.asarray(cholK, dtype)
    yd = jnp.asarray(y, dtype)
    indsd = jnp.asarray(inds, dtype)
    hp = dict(a_sig=a_sig, b_sig=b_sig, a_phi=a_phi, b_phi=b_phi,
              a1=a1, a2=a2)

    # ---- init from the prior (BNP_covreg_varinds.m:66-97) ----
    key = jax.random.PRNGKey(seed)
    key, *ik = jax.random.split(key, 7)
    delta = jnp.concatenate([
        jax.random.gamma(ik[0], jnp.full((1,), a1, dtype)),
        jax.random.gamma(ik[1], jnp.full((L - 1,), a2, dtype))])
    tau = jnp.exp(jnp.cumsum(jnp.log(delta)))
    phi = jax.random.gamma(ik[2], jnp.full((p, L), a_phi, dtype)) / b_phi
    theta = jax.random.normal(ik[3], (p, L), dtype) / \
        jnp.sqrt(phi * tau[None, :])
    xi = jax.random.normal(ik[4], (k, N), dtype)
    invSig = jax.random.gamma(ik[5], jnp.full((p,), a_sig, dtype)) / b_sig
    state = dict(theta=theta, zeta=jnp.zeros((L, k, N), dtype),
                 psi=jnp.zeros((k, N), dtype), xi=xi, phi=phi, delta=delta,
                 invSig=invSig)
    # initialization draw of zeta, then a 50-inner-iteration first psi
    # pass (BNP_covreg_varinds.m:95-97, 372-376)
    key, k0, k1 = jax.random.split(key, 3)
    state["zeta"] = jax.jit(
        functools.partial(_sample_zeta, L=L, k=k))(
            k0, state, yd, indsd, Kd, cholKd)
    if latent_mean:
        state["psi"] = jax.jit(
            functools.partial(_sample_psi, k=k, niters=50))(
                k1, state, yd, indsd, Kd, cholKd)

    def sweep_chunk(key0, state):
        def body(carry, kiter):
            st = _gibbs_iter(kiter, carry, yd, indsd, Kd, cholKd, L, k,
                             hp, psi_iters=5, latent_mean=latent_mean)
            return st, None
        state, _ = jax.lax.scan(body, state, jax.random.split(key0, chunk))
        mu, vd = _mu_and_vardiag(state)
        return state, mu, vd

    sweep_chunk = jax.jit(sweep_chunk)

    if store_every % chunk != 0 and chunk % store_every != 0:
        raise ValueError("chunk must divide or be divisible by store_every")
    chunk = min(chunk, store_every)

    mus, vds = [], []
    nchunks = niter // chunk
    for i in range(nchunks):
        key, kc = jax.random.split(key)
        state, mu, vd = sweep_chunk(kc, state)
        it = (i + 1) * chunk
        if it > nburn and it % store_every == 0:
            mus.append(np.asarray(mu))
            vds.append(np.asarray(vd))
        if verbose and it % max(store_every * 10, chunk) == 0:
            print(f"  bnp-covreg iter {it}/{niter}", flush=True)
    return {"mu": np.stack(mus), "var_diag": np.stack(vds), "state": state}
