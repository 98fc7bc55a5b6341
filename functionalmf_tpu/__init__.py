"""functionalmf_tpu: Bayesian Tensor Filtering on accelerators with JAX.

A from-scratch JAX/XLA framework with the capabilities of the
reference `functionalmf` library (Tansey, Tosh & Blei, *Bayesian Tensor
Filtering*, AoAS 2021): Gibbs inference for functional matrix factorization
Y[i, j, t] ~ f(<W_i, V_{j,t}>) under trend-filtering/horseshoe priors, with
Gaussian, Binomial, Negative-Binomial, and black-box (optionally linearly
constrained) likelihoods.
"""

from functionalmf_tpu.models.base import BayesianTensorFiltering
from functionalmf_tpu.models.gaussian import GaussianBayesianTensorFiltering

__all__ = [
    "BayesianTensorFiltering",
    "GaussianBayesianTensorFiltering",
    "BinomialBayesianTensorFiltering",
    "NegativeBinomialBayesianTensorFiltering",
    "NonconjugateBayesianTensorFiltering",
    "ConstrainedNonconjugateBayesianTensorFiltering",
    "gass",
    "elliptical_slice",
    "polya_gamma",
    "sample_mvn",
    "sample_mvn_from_precision",
    "sample_mvn_from_covariance",
]

__version__ = "0.1.0"

from functionalmf_tpu.samplers.gass import gass
from functionalmf_tpu.samplers.ess import elliptical_slice
from functionalmf_tpu.ops.polyagamma import polya_gamma
from functionalmf_tpu.ops.mvn import (
    sample_mvn, sample_mvn_from_precision, sample_mvn_from_covariance)


def __getattr__(name):
    # Lazy imports keep `import functionalmf_tpu` light.
    if name in ("BinomialBayesianTensorFiltering",):
        from functionalmf_tpu.models.binomial import BinomialBayesianTensorFiltering
        return BinomialBayesianTensorFiltering
    if name in ("NegativeBinomialBayesianTensorFiltering",):
        from functionalmf_tpu.models.negbinom import NegativeBinomialBayesianTensorFiltering
        return NegativeBinomialBayesianTensorFiltering
    if name in ("NonconjugateBayesianTensorFiltering",):
        from functionalmf_tpu.models.nonconjugate import NonconjugateBayesianTensorFiltering
        return NonconjugateBayesianTensorFiltering
    if name in ("ConstrainedNonconjugateBayesianTensorFiltering",):
        from functionalmf_tpu.models.constrained import (
            ConstrainedNonconjugateBayesianTensorFiltering)
        return ConstrainedNonconjugateBayesianTensorFiltering
    raise AttributeError(name)
