"""Bayesian tensor filtering for dose-response modeling (CLI).

JAX re-design of the reference doseresponse/fit.py:1-491:
empirical-Bayes likelihood -> NMF / monotone-NMF baselines -> constrained
BTF with [0,1] + softened-monotonicity constraints, EP centering, optional
binary row features with a U embedding resampled by GASS inside a per-step
callback, holdout evaluation, PAV-projected posterior, and saved artifacts.

Design deltas: the reference publishes Y/X/U through POSIX shared memory and
passes a *dummy* tensor as run_gibbs data (fit.py:305-307, 348); here the
real data pytree {Y, X, U} flows through run_gibbs as traced inputs, and the
callback updates U via `model.mark_data_dirty()`.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import jax
import jax.numpy as jnp

from functionalmf_tpu import ConstrainedNonconjugateBayesianTensorFiltering
from functionalmf_tpu.apps.doseresponse.empirical_bayes import estimate_likelihood
from functionalmf_tpu.samplers.gass import gass
from functionalmf_tpu.utils import tensor_nmf, ep_from_mf, factor_pav, mse, mae


def load_data_as_pandas(filename):
    import pandas as pd
    return pd.read_csv(filename, header=0)


def make_loglikelihood(likelihood, with_features: bool):
    """Traceable loglikelihood(data, WV, W, V, row, col) closing over the EB
    mixture (reference fit.py:28-50). data = {'Y', ['X', 'U']}."""

    def base(data, WV, W, V, row=None, col=None):
        Y = data["Y"]
        if row is not None:
            Y = Y[row]
        if col is not None:
            Y = Y[:, col]
        # Y: (..., T, R); WV: (..., T)
        return jnp.sum(likelihood.logpdf(Y, WV))
    if not with_features:
        return base

    def with_X(data, WV, W, V, row=None, col=None):
        z = base(data, WV, W, V, row=row, col=col)
        if row is not None:
            X, U = data["X"], data["U"]
            WU = jnp.clip(U[:, :W.shape[-1]] @ W, 1e-6, 1 - 1e-6)  # (p,)
            x_i = X[row]
            ce = x_i * jnp.log(WU) + (1 - x_i) * jnp.log(1 - WU)
            z = z + jnp.sum(jnp.where(jnp.isnan(x_i), 0.0, ce))
        elif col is None:
            # full-tensor call (logprob / the ASIS sigma2 interweave,
            # models/constrained.py:_interweave_scales): the feature term
            # p(X | W U) depends on W, so it must be included for ALL
            # rows here — omitting it would bias the W-scale move. Column
            # updates (col is not None) may still omit it: it is constant
            # in V, so it cancels from the GASS slice test.
            X, U = data["X"], data["U"]
            WU = jnp.clip(jnp.einsum("nk,pk->np", W,
                                     U[:, :W.shape[-1]]), 1e-6, 1 - 1e-6)
            ce = X * jnp.log(WU) + (1 - X) * jnp.log(1 - WU)
            z = z + jnp.sum(jnp.where(jnp.isnan(X), 0.0, ce))
        return z

    return with_X


def _make_u_all(X):
    """GASS resampling of the feature embeddings U given W (reference
    fit.py:113-144), vmapped over feature columns. jax-traceable."""
    Xj = jnp.asarray(np.where(np.isnan(X), 0.0, X), jnp.float32)
    Xmask = jnp.asarray((~np.isnan(X)).astype(np.float32))

    def u_all(key, U, W):
        # constraints: W u in [0, 1] for every row i (fit.py:116-118)
        n = W.shape[0]
        A = jnp.concatenate([W, -W], axis=0)
        c = jnp.concatenate([jnp.zeros(n), -jnp.ones(n)])

        def one(i, u_i, k_i):
            def loglik(cands):  # (G, k)
                wu = jnp.clip(cands @ W.T, 1e-6, 1 - 1e-6)  # (G, n)
                ce = (Xj[None, :, i] * jnp.log(wu)
                      + (1 - Xj[None, :, i]) * jnp.log(1 - wu))
                return jnp.sum(ce * Xmask[None, :, i], axis=-1)

            u_new, _ = gass(k_i, u_i, lambda kk: jax.random.normal(kk, u_i.shape),
                            loglik, A, c, ngrid=64)
            return u_new

        p = U.shape[0]
        keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(
            jnp.arange(p, dtype=jnp.uint32))
        return jax.vmap(one)(jnp.arange(p), U, keys)
    return u_all


def make_u_step(args, X, U_samples):
    """Host-callback flavor of the U step (reference contract; one host
    round trip per sweep). Kept for non-traceable user hooks; the compiled default is
    make_traced_u_step."""
    u_all = jax.jit(_make_u_all(X))

    def U_step(model, data, step):
        key = jax.random.fold_in(jax.random.PRNGKey(args.seed ^ 0xFEA7), step)
        W = jnp.asarray(model.W)
        U = jnp.asarray(data["U"], jnp.float32)
        U_new = np.asarray(u_all(key, U, W))
        data["U"] = U_new
        model.mark_data_dirty()

        # refresh the W row constraints so W U stays in [0, 1] (fit.py:133-137)
        Row_zero = np.concatenate([U_new, np.zeros((U_new.shape[0], 1))], axis=1)
        Row_one = np.concatenate([-U_new, np.full((U_new.shape[0], 1), -1.0)], axis=1)
        model.Row_constraints = np.concatenate([Row_zero, Row_one], axis=0)

        if step >= args.nburn and (step - args.nburn) % args.nthin == 0:
            sidx = (step - args.nburn) // args.nthin
            U_samples[sidx] = U_new

    return U_step


def make_traced_u_step(X):
    """Compiled flavor: the U step traces INTO the chunked Gibbs executables
    (run_gibbs traced_callback contract), so the whole features pipeline
    runs inside one XLA loop with zero per-sweep host dispatch. Requires
    nchains == 1 (enforced by init_model for --sample_features)."""
    u_all = _make_u_all(X)

    def traced_u(state, pdata, key, step):
        W = state["W"][0]                       # single chain
        U_new = u_all(key, pdata["U"], W)
        pdata = dict(pdata, U=U_new)
        # refresh the W row constraints so W U stays in [0, 1]
        # (reference fit.py:133-137); Row_constraints are traced state
        p = U_new.shape[0]
        Row_zero = jnp.concatenate([U_new, jnp.zeros((p, 1))], axis=1)
        Row_one = jnp.concatenate([-U_new, jnp.full((p, 1), -1.0)], axis=1)
        RC = jnp.concatenate([Row_zero, Row_one], axis=0)
        state = dict(state, Row_constraints=RC[None].astype(
            state["Row_constraints"].dtype))
        return state, pdata

    return traced_u


def init_model(Y, likelihood, args, X=None):
    """Constraints + NMF warm start + EP centering (reference fit.py:54-187)."""
    ndepth = Y.shape[2]
    C_zero = np.concatenate([np.eye(ndepth), np.zeros((ndepth, 1))], axis=1)
    C_mono = np.array([np.concatenate([np.zeros(i), [1, -1],
                                       np.zeros(ndepth - i - 2), [-1e-2]])
                       for i in range(ndepth - 1)])
    C_one = np.concatenate([np.eye(ndepth) * -1, np.full((ndepth, 1), -1)], axis=1)
    C = np.concatenate([C_zero, C_one, C_mono], axis=0)

    rng = np.random.default_rng(args.seed)
    U_samples, callback, Row_constraints, U0 = None, None, None, None

    if X is not None:
        print("Initializing dose-response embeddings via NMF with row features")
        W, V, U0 = tensor_nmf(Y, args.nembeds, monotone=True, max_entry=0.999,
                              row_features=X, rng=rng)
        if args.sample_features:
            Row_zero = np.concatenate([U0, np.zeros((U0.shape[0], 1))], axis=1)
            Row_one = np.concatenate([-U0, np.full((U0.shape[0], 1), -1.0)], axis=1)
            Row_constraints = np.concatenate([Row_zero, Row_one], axis=0)
            U_samples = np.zeros((args.nsamples,) + U0.shape)
        loglikelihood = make_loglikelihood(likelihood, with_features=True)
    else:
        print("Initializing dose-response embeddings via NMF")
        W, V = tensor_nmf(Y, args.nembeds, monotone=True, max_entry=0.999, rng=rng)
        loglikelihood = make_loglikelihood(likelihood, with_features=False)

    Mu = (W[:, None, None] * V[None]).sum(axis=-1)
    assert Mu.min() >= 0, "Mu range [{},{}]".format(Mu.min(), Mu.max())
    assert Mu.max() <= 1, "Mu range [{},{}]".format(Mu.min(), Mu.max())

    EP_approx = ep_from_mf(Y, W, V, mode="multiplier", multiplier=3)

    fix_W = X is not None and not args.sample_features
    nchains = int(getattr(args, "nchains", 1))
    if nchains > 1 and args.sample_features:
        # the U-resampling callback tracks a single shared U; per-chain U
        # would need a chain axis through the likelihood closure
        print("WARNING: --sample_features forces nchains=1")
        nchains = 1
    model = ConstrainedNonconjugateBayesianTensorFiltering(
        Y.shape[0], Y.shape[1], Y.shape[2],
        loglikelihood, C,
        nembeds=args.nembeds, tf_order=args.tf_order,
        lam2_true=args.lam2, ep_approx=EP_approx,
        W_true=W if fix_W else None,
        Row_constraints=Row_constraints,
        nchains=nchains,
        seed=args.seed)
    model.W = W
    model.V = V
    return model, U_samples, U0


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Bayesian tensor filtering for dose-response modeling.")
    parser.add_argument("--data", default="doseresponse/data/sim/data.csv")
    parser.add_argument("--outdir", default="doseresponse/data/sim/")
    parser.add_argument("--nembeds", type=int, default=5)
    parser.add_argument("--tf_order", type=int, default=2)
    parser.add_argument("--lam2", type=float, default=1e-1)
    parser.add_argument("--nbins", type=int, default=20)
    parser.add_argument("--nsamples", type=int, default=5000)
    parser.add_argument("--nburn", type=int, default=5000)
    parser.add_argument("--nthin", type=int, default=1)
    parser.add_argument("--nchains", type=int, default=1)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--nthreads", type=int, default=3)  # parity; unused
    parser.add_argument("--nholdout", type=int, default=0)
    parser.add_argument("--features", help="optional binary row-feature CSV")
    parser.add_argument("--sample_features", action="store_true")
    parser.add_argument("--host-callback", action="store_true",
                        help="run the U step as a per-step host callback "
                             "(the reference's contract) instead of tracing "
                             "it into the compiled Gibbs loop")
    args = parser.parse_args(argv)

    rng = np.random.default_rng(args.seed)
    df = load_data_as_pandas(args.data)

    print("Loading data and performing empirical Bayes likelihood estimate")
    Y, likelihood, cells, drugs, concentrations, control_obs = \
        estimate_likelihood(df, nbins=args.nbins, tensor_outcomes=True)

    os.makedirs(args.outdir, exist_ok=True)
    np.save(os.path.join(args.outdir, "cells"), cells)
    np.save(os.path.join(args.outdir, "drugs"), drugs)

    nrows, ncols, ndepth, nreplicates = Y.shape
    present = np.any(np.any(~np.isnan(Y), axis=-1), axis=-1).sum()
    print("Shape: {}x{}x{}x{}. Curves present: {}/{}".format(
        nrows, ncols, ndepth, nreplicates, present, nrows * ncols))

    # holdout (fit.py:282-302)
    Y_full = Y
    held_out = None
    if args.nholdout > 0:
        from functionalmf_tpu.utils import random_holdouts
        selected = random_holdouts(Y, args.nholdout, rng=rng)
        held_out = selected.T
        Y = Y.copy()
        Y[held_out[0], held_out[1]] = np.nan

    # features (fit.py:64-99)
    X = None
    if args.features is not None:
        import pandas as pd
        fdf = pd.read_csv(args.features, index_col=0, header=0)
        have_both = [c for c in cells if c in fdf.index]
        print("Have dose-response and features: {}".format(len(have_both)))
        X = np.array([fdf.loc[c].values if c in fdf.index
                      else np.full(len(fdf.columns), np.nan) for c in cells],
                     dtype=float)

    # NMF baselines (fit.py:309-319)
    print("Fitting NMF")
    W_nmf, V_nmf = tensor_nmf(Y, args.nembeds, max_entry=0.999, rng=rng)
    Mu_nmf = (W_nmf[:, None, None] * V_nmf[None]).sum(axis=-1)
    print("Fitting Monotone NMF")
    W_nmf_proj, V_nmf_proj = tensor_nmf(Y, args.nembeds, monotone=True,
                                        max_entry=0.999, rng=rng)
    Mu_nmf_proj = (W_nmf_proj[:, None, None] * V_nmf_proj[None]).sum(axis=-1)

    print("Initializing model")
    model, U_samples, U0 = init_model(Y, likelihood, args, X=X)

    data = {"Y": Y}
    callback, traced_cb, cdk = None, None, ()
    if X is not None:
        data["X"] = X
        data["U"] = U0
        if args.sample_features:
            if args.host_callback:
                callback = make_u_step(args, X, U_samples)
            else:
                # default: compile the U step into the Gibbs loop (zero
                # per-sweep host dispatch; bench/callback_path.py measures
                # the difference)
                traced_cb = make_traced_u_step(X)
                cdk = ("U",)

    print("Running Gibbs sampler. burn={} thin={} samples={}".format(
        args.nburn, args.nthin, args.nsamples))
    results = model.run_gibbs(data, nburn=args.nburn, nthin=args.nthin,
                              nsamples=args.nsamples, print_freq=100,
                              callback=callback, traced_callback=traced_cb,
                              collect_data_keys=cdk)
    if "U" in results:
        U_samples = results.pop("U")
    model.shutdown()
    Ws, Vs = results["W"], results["V"]

    # multi-chain convergence check (the reference parses --nchains and
    # never uses it, fit.py:237; chains are first-class here)
    if model.nchains > 1:
        from functionalmf_tpu.utils.diagnostics import split_rhat
        C, S = model.nchains, args.nsamples
        rng_r = np.random.default_rng(0)
        rhats = []
        for arr in (Ws, Vs):
            flat = arr.reshape(C, S, -1)
            idx = rng_r.choice(flat.shape[-1], size=min(64, flat.shape[-1]),
                               replace=False)
            rhats.extend(split_rhat(flat[:, :, j]) for j in idx)
        print("split-R-hat over {} chains: max {:.4f} median {:.4f}".format(
            C, float(np.max(rhats)), float(np.median(rhats))))

    Mu_hat = np.einsum("znk,zmtk->znmt", Ws, Vs)
    Mu_hat_mean = Mu_hat.mean(axis=0)

    # PAV-projected posterior (fit.py:365-374)
    Ws_proj = Ws
    Vs_proj = np.array([[factor_pav(W_i, V_ij) for V_ij in V_i]
                        for W_i, V_i in zip(Ws, Vs)])
    Mu_hat_proj = np.einsum("znk,zmtk->znmt", Ws_proj, Vs_proj)

    def nll(pred, obs):
        return -float(np.sum(np.asarray(
            likelihood.logpdf(jnp.asarray(np.where(np.isnan(obs), np.nan, obs)),
                              jnp.asarray(pred)))))

    print("MAE on in-sample observations:")
    print("NMF:            {}".format(mae(Mu_nmf[..., None], Y)))
    print("Monotone NMF:   {}".format(mae(Mu_nmf_proj[..., None], Y)))
    print("Posterior mean: {}".format(mae(Mu_hat_mean[..., None], Y)))
    print("RMSE on in-sample observations:")
    print("NMF:            {}".format(np.sqrt(mse(Mu_nmf[..., None], Y))))
    print("Monotone NMF:   {}".format(np.sqrt(mse(Mu_nmf_proj[..., None], Y))))
    print("Posterior mean: {}".format(np.sqrt(mse(Mu_hat_mean[..., None], Y))))

    if args.nholdout > 0:
        ho = (held_out[0], held_out[1])
        print("MAE on held out observations:")
        print("NMF:            {}".format(mae(Mu_nmf[ho][:, :, None], Y_full[ho])))
        print("Monotone NMF:   {}".format(mae(Mu_nmf_proj[ho][:, :, None], Y_full[ho])))
        print("Posterior mean: {}".format(mae(Mu_hat_mean[ho][:, :, None], Y_full[ho])))
        print("RMSE on held out observations:")
        print("NMF:            {}".format(np.sqrt(mse(Mu_nmf[ho][:, :, None], Y_full[ho]))))
        print("Monotone NMF:   {}".format(np.sqrt(mse(Mu_nmf_proj[ho][:, :, None], Y_full[ho]))))
        print("Posterior mean: {}".format(np.sqrt(mse(Mu_hat_mean[ho][:, :, None], Y_full[ho]))))

    print("Saving results to file")
    np.save(os.path.join(args.outdir, "y"), Y)
    np.save(os.path.join(args.outdir, "nmf"), Mu_nmf)
    np.save(os.path.join(args.outdir, "nmf_mono"), Mu_nmf_proj)
    np.save(os.path.join(args.outdir, "btf"), Mu_hat)
    np.save(os.path.join(args.outdir, "btf_w"), Ws)
    np.save(os.path.join(args.outdir, "btf_v"), Vs)
    np.save(os.path.join(args.outdir, "btf_mono"), Mu_hat_proj)
    if model.Sigma_ep is not None:
        np.save(os.path.join(args.outdir, "btf_ep_sigma"), np.asarray(model.Sigma_ep))
    if U_samples is not None:
        np.save(os.path.join(args.outdir, "btf_u"), U_samples)
    if args.nholdout > 0:
        np.save(os.path.join(args.outdir, "held_out"), held_out)


if __name__ == "__main__":
    main()
