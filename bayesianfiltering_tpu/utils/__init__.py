"""Numerics core: linear algebra, sigma points, resampling, SDP, metrics.

Flat namespace mirroring the reference's single ``gaussfiltax/utils.py`` so
downstream code can keep writing ``utils.psd_solve`` / ``utils.rmse`` /
``utils.optimal_resampling`` / ``utils._get_sigma_points`` etc., while the
implementation lives in focused submodules.
"""
from bayesianfiltering_tpu.utils.linalg import (
    symmetrize,
    psd_solve,
    project_to_psd,
    sqrtm_psd,
    sqrtm_psd_eigh,
    sqrtm_psd_ns,
    fast_cholesky,
    tri_inv_lower,
    cholesky_guarded,
    sandwich,
    matrix_projection,
)
from bayesianfiltering_tpu.utils.metrics import (
    mse,
    rmse,
    collapse,
    normal_KL_div,
    normal_kl,
    W_distance,
    gaussian_logpdf,
    gm,
    loss,
    dec_to_base,
)
from bayesianfiltering_tpu.utils.sigma_points import (
    sigma_points,
    _get_sigma_points,
    split_to_sigma_points,
    unscented_weights,
)
from bayesianfiltering_tpu.utils.resampling import (
    effective_sample_size,
    multinomial_resample,
    systematic_resample,
    stratified_resample,
    get_resampler,
    _resample,
    optimal_resampling,
    resample,
    retain,
    split_by_sampling,
)
from bayesianfiltering_tpu.utils.sdp import (
    sdp_opt,
    sdp_opt2,
    gradient_descent,
    sdp_opt_legacy,
    sdp_opt_test,
)
from bayesianfiltering_tpu.utils.angles import (
    wrap_angle,
    angular_residual,
)

__all__ = [
    # linalg
    "symmetrize", "psd_solve", "project_to_psd", "sqrtm_psd", "sqrtm_psd_eigh",
    "sqrtm_psd_ns", "fast_cholesky", "tri_inv_lower", "cholesky_guarded", "sandwich", "matrix_projection",
    # metrics
    "mse", "rmse", "collapse", "normal_KL_div", "normal_kl", "W_distance",
    "gaussian_logpdf", "gm", "loss", "dec_to_base",
    # sigma points
    "sigma_points", "_get_sigma_points", "split_to_sigma_points",
    "unscented_weights",
    # resampling
    "effective_sample_size", "multinomial_resample", "systematic_resample",
    "stratified_resample", "get_resampler", "_resample", "optimal_resampling",
    "resample", "retain", "split_by_sampling",
    # sdp
    "sdp_opt", "sdp_opt2", "gradient_descent", "sdp_opt_legacy", "sdp_opt_test",
    # angles
    "wrap_angle", "angular_residual",
]
