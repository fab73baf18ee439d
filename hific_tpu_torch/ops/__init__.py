from hific_tpu_torch.ops.maths import (
    lower_bound_identity,
    lower_bound_toward,
    standardized_cdf_gaussian,
    standardized_cdf_logistic,
    standardized_quantile_gaussian,
    standardized_quantile_logistic,
    quantile_gaussian,
    quantile_logistic,
    pmf_to_quantized_cdf,
)
from hific_tpu_torch.ops.padding import reflect_pad, asymmetric_pad_2x, pad_factor
from hific_tpu_torch.ops.quantize import (
    quantize_noise,
    quantize_round,
    quantize_ste,
    estimate_entropy,
    estimate_entropy_log,
)
from hific_tpu_torch.ops.channel_norm import channel_norm
