"""GASS vs. ESS-variant benchmark (reference functionalmf/gass.py:133-325).

Reproduces the reference's 5-method comparison on the monotone-[0,1] GP
recovery task: (0) GASS, (1) naive ESS + rejection, (2) logit-link ESS +
rejection, (3) naive ESS + PAV projection, (4) logit-link ESS + PAV
projection. Prints the reference's two tables — MSE x 10^3 and 90%
credible-interval coverage, mean +/- stderr over trials per sample size
(gass.py:317-324).

Design deltas: the reference runs trials serially in Python with numpy
samplers; here all trials advance together as one vmapped `lax.scan` of the
five kernels, so a 100-trial x 20k-step benchmark is a single device
program. Truth/rejection-sampling setup and PAV projection stay host-side
(numpy / the native C PAV), as in the reference.

Usage:
  python bench/gass_methods.py            # quick: 20 trials, sizes to 1000
  python bench/gass_methods.py --full     # reference scale: 100 trials,
                                          # sizes {100,500,1k,5k,10k}
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
from jax.scipy.stats import gamma as jgamma

from functionalmf_tpu.samplers.gass import gass
from functionalmf_tpu.samplers.ess import elliptical_slice
from functionalmf_tpu.utils.pav import pav

MIN_MU, MAX_MU = 0.0, 1.0


def _rejection_mvn(rng, mu, sigma, n):
    """Monotone-decreasing draws from N(mu, sigma) in [0,1] (gass.py:161-167)."""
    out = np.zeros((n, len(mu)))
    for i in range(n):
        x = rng.multivariate_normal(mu, sigma)
        while x.min() < MIN_MU or x.max() > MAX_MU or np.diff(x).max() > 0:
            x = rng.multivariate_normal(mu, sigma)
        out[i] = x
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="reference scale: 100 trials, sizes to 10000")
    ap.add_argument("--ntrials", type=int, default=None)
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args()

    ntrials = args.ntrials or (100 if args.full else 20)
    sample_sizes = np.array([100, 500, 1000, 5000, 10000] if args.full
                            else [100, 500, 1000])
    nburn = nsamples = int(sample_sizes.max())
    nobs = 3
    rng = np.random.default_rng(args.seed)

    # Monotone curve prior with squared-exponential covariance (gass.py:153-157)
    mu_prior = np.array([0.95, 0.8, 0.75, 0.5, 0.29, 0.2, 0.17, 0.15,
                         0.01, 0.0001])
    T = len(mu_prior)
    bw = 3.0
    sigma_prior = 0.1 * np.array(
        [np.exp(-0.5 * (i - np.arange(T)) ** 2 / bw) for i in range(T)])

    # Empirical logit-transformed prior moments (gass.py:159-170)
    print("Building empirical covariance for the logit-transformed model")
    mu_samples = _rejection_mvn(rng, mu_prior, sigma_prior, 1000)
    ms_logit = np.log(mu_samples / (1 - mu_samples))
    sigma_logit = np.einsum("ni,nj->nij", ms_logit, ms_logit).mean(axis=0)
    mu_logit = np.log(mu_prior / (1 - mu_prior))

    # Per-trial truths + gamma observations, Gamma(100, scale=mu_truth) as
    # in the reference (gass.py:178-186)
    truths = _rejection_mvn(rng, mu_prior, sigma_prior, ntrials)
    data = rng.gamma(100.0, np.broadcast_to(truths[:, None, :],
                                            (ntrials, nobs, T)))

    # Constraints [0,1] + monotone decreasing (gass.py:192-199)
    A = np.concatenate([np.eye(T), -np.eye(T),
                        (np.eye(T) - np.eye(T, k=1))[:-1]], axis=0)
    c = np.concatenate([np.full(T, MIN_MU), np.full(T, -MAX_MU),
                        np.zeros(T - 1)]).astype(np.float32)
    A = jnp.asarray(A, jnp.float32)
    c = jnp.asarray(c)

    L_prior = jnp.asarray(np.linalg.cholesky(sigma_prior), jnp.float32)
    L_logit = jnp.asarray(np.linalg.cholesky(
        sigma_logit + 1e-6 * np.eye(T)), jnp.float32)
    mu_p = jnp.asarray(mu_prior, jnp.float32)
    mu_l = jnp.asarray(mu_logit, jnp.float32)
    data_j = jnp.asarray(data, jnp.float32)

    def loglik_nat(y, z):  # (T,) in natural space
        return jnp.sum(jgamma.logpdf(y, 100.0, scale=z[None, :]))

    def feasible(z):
        return (jnp.min(z) >= MIN_MU) & (jnp.max(z) <= MAX_MU) & \
               (jnp.max(jnp.diff(z)) <= 0)

    # initial point: downward line (gass.py:201-207)
    x0_nat = np.clip((T - np.arange(T)) / T, MIN_MU + 0.01, MAX_MU - 0.01)
    x0_logit = np.log(x0_nat / (1 - x0_nat))

    def step_one(key, y, x, ll):
        """Advance the 5 method states one step for one trial.

        x: (5, T) — methods 2 and 4 live in logit space."""
        ks = jax.random.split(key, 10)

        # (0) GASS
        v0 = L_prior @ jax.random.normal(ks[0], (T,))
        x_g, ll_g = gass(ks[1], x[0], None,
                         lambda pts: jax.vmap(lambda z: loglik_nat(y, jnp.clip(
                             z, 1e-6, None)))(pts),
                         A, c, mu=mu_p, cur_ll=ll[0], ngrid=100, v=v0)

        # (1) naive ESS + rejection
        def ll_rej_nat(z):
            return jnp.where(feasible(z), loglik_nat(y, jnp.clip(z, 1e-6, None)),
                             -jnp.inf)
        nu1 = L_prior @ jax.random.normal(ks[2], (T,))
        x_r, ll_r = elliptical_slice(ks[3], x[1], nu1, ll_rej_nat,
                                     cur_ll=ll[1], mu=mu_p)

        # (2) logit ESS + rejection (monotonicity only; bounds via the link)
        def ll_rej_logit(zl):
            z = jax.nn.sigmoid(zl)
            return jnp.where(jnp.max(jnp.diff(z)) <= 0, loglik_nat(y, z),
                             -jnp.inf)
        nu2 = L_logit @ jax.random.normal(ks[4], (T,))
        x_lr, ll_lr = elliptical_slice(ks[5], x[2], nu2, ll_rej_logit,
                                       cur_ll=ll[2], mu=mu_l)

        # (3) naive ESS, project later
        def ll_nat_clip(z):
            return loglik_nat(y, jnp.clip(z, 1e-6, None))
        nu3 = L_prior @ jax.random.normal(ks[6], (T,))
        x_p, ll_p = elliptical_slice(ks[7], x[3], nu3, ll_nat_clip,
                                     cur_ll=ll[3], mu=mu_p)

        # (4) logit ESS, project later
        def ll_logit(zl):
            return loglik_nat(y, jax.nn.sigmoid(zl))
        nu4 = L_logit @ jax.random.normal(ks[8], (T,))
        x_lp, ll_lp = elliptical_slice(ks[9], x[4], nu4, ll_logit,
                                       cur_ll=ll[4], mu=mu_l)

        return (jnp.stack([x_g, x_r, x_lr, x_p, x_lp]),
                jnp.stack([ll_g, ll_r, ll_lr, ll_p, ll_lp]))

    vstep = jax.vmap(step_one, in_axes=(0, 0, 0, 0))

    def chain(keys, data_all, x_init, ll_init):
        def body(carry, key_t):
            x, ll = carry
            x, ll = vstep(key_t, data_all, x, ll)
            return (x, ll), None

        def body_collect(carry, key_t):
            x, ll = carry
            x, ll = vstep(key_t, data_all, x, ll)
            return (x, ll), x

        (x, ll), _ = jax.lax.scan(body, (x_init, ll_init), keys[:nburn])
        (_, _), samples = jax.lax.scan(body_collect, (x, ll), keys[nburn:])
        return samples  # (nsamples, ntrials, 5, T)

    x_init = np.tile(np.stack([x0_nat, x0_nat, x0_logit, x0_nat, x0_logit]),
                     (ntrials, 1, 1)).astype(np.float32)
    ll_init = np.full((ntrials, 5), -1e30, np.float32)

    key = jax.random.PRNGKey(args.seed)
    keys = jax.vmap(lambda s: jax.random.split(jax.random.fold_in(key, s),
                                               ntrials))(
        jnp.arange(nburn + nsamples, dtype=jnp.uint32))

    print(f"Running {ntrials} trials x {nburn + nsamples} steps x 5 methods "
          "as one vmapped scan")
    samples = np.array(jax.jit(chain)(keys, data_j, jnp.asarray(x_init),
                                      jnp.asarray(ll_init)))

    # logit methods back to natural scale; PAV-project methods 3 and 4
    # (gass.py:248-255)
    samples[:, :, (2, 4)] = 1.0 / (1.0 + np.exp(-samples[:, :, (2, 4)]))
    for mi in (3, 4):
        flat = samples[:, :, mi].reshape(-1, T)
        for i in range(flat.shape[0]):
            flat[i] = np.asarray(pav(flat[i][::-1]))[::-1].clip(0, 1)
        samples[:, :, mi] = flat.reshape(nsamples, ntrials, T)

    methods = ["GASS", "RS", "LRS", "PP", "LPP"]
    nsizes = len(sample_sizes)
    mse = np.zeros((ntrials, nsizes, 5))
    cov = np.zeros((ntrials, nsizes, 5))
    for si, ss in enumerate(sample_sizes):
        sub = samples[:ss]                      # (ss, ntrials, 5, T)
        mu_hat = sub.mean(axis=0)
        lo = np.percentile(sub, 5, axis=0)
        hi = np.percentile(sub, 95, axis=0)
        tr = truths[:, None, :]
        mse[:, si] = ((tr - mu_hat) ** 2).mean(axis=-1)
        cov[:, si] = ((tr >= lo) & (tr <= hi)).mean(axis=-1)

    mse = mse * 1e3
    print("\nMSE x 10^3 (mean +/- stderr over trials); "
          "columns = sample sizes", list(sample_sizes))
    for mi, m in enumerate(methods):
        cells = [f"{mse[:, si, mi].mean():6.2f} +/- "
                 f"{mse[:, si, mi].std() / np.sqrt(ntrials):4.2f}"
                 for si in range(nsizes)]
        print(f"  {m:5s} " + " | ".join(cells))
    print("\n90% credible-interval coverage")
    for mi, m in enumerate(methods):
        cells = [f"{cov[:, si, mi].mean():5.2f} +/- "
                 f"{cov[:, si, mi].std() / np.sqrt(ntrials):4.2f}"
                 for si in range(nsizes)]
        print(f"  {m:5s} " + " | ".join(cells))

    import json
    out = {
        "ntrials": int(ntrials),
        "sample_sizes": [int(s) for s in sample_sizes],
        "methods": methods,
        "mse_x1e3_mean": {m: [round(float(mse[:, si, mi].mean()), 3)
                              for si in range(nsizes)]
                          for mi, m in enumerate(methods)},
        "mse_x1e3_stderr": {m: [round(float(mse[:, si, mi].std()
                                            / np.sqrt(ntrials)), 3)
                                for si in range(nsizes)]
                            for mi, m in enumerate(methods)},
        "coverage90_mean": {m: [round(float(cov[:, si, mi].mean()), 3)
                                for si in range(nsizes)]
                            for mi, m in enumerate(methods)},
        "coverage90_stderr": {m: [round(float(cov[:, si, mi].std()
                                              / np.sqrt(ntrials)), 3)
                                  for si in range(nsizes)]
                              for mi, m in enumerate(methods)},
    }
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "gass_methods.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"\nwrote {path}")


if __name__ == "__main__":
    main()
