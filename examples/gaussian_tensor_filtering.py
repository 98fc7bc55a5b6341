"""Gaussian functional matrix factorization example.

Mirrors the reference examples/gaussian_tensor_filtering.py:1-107 against
the JAX API: synthetic wiggly-with-jumps truth, 11x12x20 tensor,
hold out the [:3,:3] block, run Gibbs, report held-out error and coverage,
optionally plot credible bands.
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from functionalmf_tpu import GaussianBayesianTensorFiltering
from functionalmf_tpu.utils import mse, mae, coverage_at

nrows, ncols, ndepth = 11, 12, 20
nembeds = 3
nreplicates = 1
nu2_truth = 9


def init_model(tf_order=2, lam2=0.1, sigma2=0.5, nu2=1, seed=0):
    # reference example:21-26
    return GaussianBayesianTensorFiltering(nrows, ncols, ndepth,
                                           nembeds=nembeds, tf_order=tf_order,
                                           sigma2_init=sigma2,
                                           lam2_init=lam2, nu2_init=nu2,
                                           seed=seed)


def create_wiggly_with_jumps(rng, break_prob=0.3):
    # reference example:28-44
    W = rng.normal(0, 1, size=(nrows, nembeds))
    if nrows > 1:
        W[np.triu_indices(nembeds, k=1)] = 0
    V = np.zeros((ncols, ndepth, nembeds))
    for j in range(ncols):
        x = rng.normal(0, 1, size=nembeds)
        coef = rng.normal(0, 1)
        V[j, -1] = x
        for k in range(ndepth - 2, -1, -1):
            V[j, k] = V[j, k + 1]
            if rng.random() < break_prob:
                coef = rng.normal(0, 1)
                x = rng.normal(0, 1, size=nembeds)
            V[j, k] += coef * x
    return W, V


if __name__ == "__main__":
    seed = int(sys.argv[1]) if len(sys.argv) > 1 else 1
    nburn, nthin, nsamples = 1000, 1, 1000
    rng = np.random.default_rng(seed)

    model = init_model(seed=seed)
    W_true, V_true = create_wiggly_with_jumps(rng)
    Mu = np.einsum("nk,mtk->nmt", W_true, V_true)
    print("Mean ranges: [{},{}]".format(Mu.min(), Mu.max()))

    Y = rng.normal(Mu[..., None], np.sqrt(nu2_truth),
                   size=(nrows, ncols, ndepth, nreplicates))
    Y_missing = Y.copy()
    Y_missing[:3, :3] = np.nan

    results = model.run_gibbs(Y_missing, nburn=nburn, nthin=nthin,
                              nsamples=nsamples, print_freq=50, verbose=True)
    Ws, Vs = results["W"], results["V"]

    Mu_hat = np.einsum("znk,zmtk->znmt", Ws, Vs)
    Mu_hat_mean = Mu_hat.mean(axis=0)

    print("held-out MAE:  {:.4f}".format(mae(Mu[:3, :3], Mu_hat_mean[:3, :3])))
    print("held-out RMSE: {:.4f}".format(np.sqrt(mse(Mu[:3, :3], Mu_hat_mean[:3, :3]))))
    print("90% coverage:  {:.1f}%".format(coverage_at(Mu, Mu_hat, 90)))
    print("nu2 estimate:  {:.3f} (truth {})".format(results["nu2"].mean(), nu2_truth))

    if os.environ.get("PLOT"):
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        Mu_hat_upper = np.percentile(Mu_hat, 95, axis=0)
        Mu_hat_lower = np.percentile(Mu_hat, 5, axis=0)
        X = np.arange(ndepth)
        fig, axarr = plt.subplots(nrows, ncols, figsize=(5 * ncols, 5 * nrows),
                                  sharex=True, sharey=True)
        for i in range(nrows):
            for j in range(ncols):
                ax = axarr[i, j]
                ax.plot(X, Mu[i, j], color="black")
                for k in range(ndepth):
                    ax.scatter(np.full(Y.shape[-1], X[k]), Y[i, j, k], color="gray")
                ax.plot(X, Mu_hat_mean[i, j], color="orange")
                ax.fill_between(X, Mu_hat_lower[i, j], Mu_hat_upper[i, j],
                                color="orange", alpha=0.5)
        os.makedirs("plots", exist_ok=True)
        plt.savefig("plots/gaussian-tensor-filtering.pdf", bbox_inches="tight")
        plt.close()
