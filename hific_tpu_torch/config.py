"""Model configuration, a copy of the JAX package's `Config`.

Kept field for field so that an artifact's `__config_json__` (written by the
JAX package's `export_params_npz`) parses unchanged with `Config.from_json`.
The codec and the trainer read it, both stages: `mse_lpips_config` is the
compression stage's, `hific_config` the GAN stage's.
"""

import dataclasses
import json
from typing import Optional, Tuple


class ModelTypes:
    COMPRESSION = "compression"
    COMPRESSION_GAN = "compression_gan"


# Paper Table 3a regimes.
TARGET_RATE_MAP = {"low": 0.14, "med": 0.3, "high": 0.45}
LAMBDA_A_MAP = {"low": 2.0 ** 1, "med": 2.0 ** 0, "high": 2.0 ** (-1)}


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Piecewise-constant multiplier schedule: value = base * vals[i], where
    i is the number of boundaries in `steps` already passed."""

    vals: Tuple[float, ...] = (1.0,)
    steps: Tuple[int, ...] = ()


@dataclasses.dataclass(frozen=True)
class Config:
    # Experiment
    name: str = "hific_v0.1"
    model_type: str = ModelTypes.COMPRESSION
    regime: str = "low"

    # Training
    n_steps: int = 1_000_000
    batch_size: int = 8
    crop_size: int = 256
    learning_rate: float = 1e-4
    weight_decay: float = 1e-6
    log_interval: int = 1000
    save_interval: int = 50_000
    discriminator_steps: int = 0

    # Architecture (defaults = paper Table 3a)
    latent_channels: int = 220
    n_residual_blocks: int = 9
    hyperlatent_filters: int = 320
    use_channel_norm: bool = True
    likelihood_type: str = "gaussian"
    normalize_input_image: bool = False
    sample_noise: bool = False
    noise_dim: int = 32

    # DLMM variant
    use_latent_mixture_model: bool = False
    mixture_components: int = 4
    latent_channels_dlmm: int = 64

    # Loss weights
    lambda_B: float = 2.0 ** (-4)
    k_M: float = 0.075 * 2.0 ** (-5)
    k_P: float = 1.0
    beta: float = 0.15
    gan_loss_type: str = "non_saturating"

    # Schedules
    lambda_schedule: Schedule = Schedule(vals=(2.0, 1.0), steps=(50_000,))
    lr_schedule: Schedule = Schedule(vals=(1.0, 0.1), steps=(500_000,))
    target_schedule: Schedule = Schedule(vals=(0.20 / 0.14, 1.0), steps=(50_000,))
    ignore_schedule: bool = False

    # Compute. `dtype` means what it means in the JAX package: "bfloat16"
    # computes every conv stack in bfloat16 and keeps the transposed convs'
    # parameters (and their Adam moments) in bfloat16; the rest of the
    # parameters, and the density, stay float32. `use_remat` recomputes
    # each generator residual block in the backward. `s2d_encoder_front`
    # runs the encoder's stem and first downsample, `d2s_generator_tail`
    # the generator's last upsample and projection, on a packed
    # half-resolution grid (`ops/s2d.py`, `ops/d2s.py`): the same function
    # of the same parameters, summed in another order, so a config means
    # the same program in both packages; each falls back to the plain
    # layers under instance norm (s2d also for an odd H or W).
    # `use_pallas_norm` names the TPU package's norm kernel: accepted so
    # that configs parse (the norm always runs the CUDA kernel on a GPU
    # tensor).
    dtype: str = "float32"
    use_pallas_norm: bool = False
    s2d_encoder_front: bool = False
    d2s_generator_tail: bool = True
    use_remat: bool = False

    # Rate target resolved from regime unless explicitly set
    target_rate: Optional[float] = None
    lambda_A: Optional[float] = None

    def __post_init__(self):
        if self.target_rate is None:
            object.__setattr__(self, "target_rate", TARGET_RATE_MAP[self.regime])
        if self.lambda_A is None:
            object.__setattr__(self, "lambda_A", LAMBDA_A_MAP[self.regime])

    @property
    def norm_type(self):
        return "channel" if self.use_channel_norm else "instance"

    @property
    def use_discriminator(self):
        return self.model_type == ModelTypes.COMPRESSION_GAN

    @property
    def effective_latent_channels(self):
        return (self.latent_channels_dlmm if self.use_latent_mixture_model
                else self.latent_channels)

    def to_json(self):
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, s):
        d = json.loads(s)
        for key in ("lambda_schedule", "lr_schedule", "target_schedule"):
            if key in d and isinstance(d[key], dict):
                d[key] = Schedule(vals=tuple(d[key]["vals"]),
                                  steps=tuple(d[key]["steps"]))
        return cls(**d)

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def mse_lpips_config(**kw) -> Config:
    """Rate + MSE + LPIPS, no discriminator: the first training stage."""
    kw.setdefault("model_type", ModelTypes.COMPRESSION)
    return Config(**kw)


def hific_config(**kw) -> Config:
    """The full generative loss: one discriminator step after each
    generator step, non-saturating GAN loss (the second training stage)."""
    kw.setdefault("model_type", ModelTypes.COMPRESSION_GAN)
    kw.setdefault("discriminator_steps", 1)
    kw.setdefault("gan_loss_type", "non_saturating")
    return Config(**kw)
