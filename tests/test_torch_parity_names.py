"""Every public name of the JAX package has a counterpart in the port.

An AST walk (nothing is imported) over every module of `hific_tpu/`: each
public function, class and method (a name without a leading underscore,
at module level or in a public class) must have a counterpart of the same
qualified name in the same module of `hific_tpu_torch/`, or stand in
`NO_COUNTERPART` with the reason the port has none. The reasons are
differences of idiom between JAX/Flax and PyTorch; a name the port lacks
for want of a port does not belong there. An entry that no longer
names a JAX name without a counterpart fails too, so the list stays
exact.
"""

import ast
import pathlib

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX, PORT = ROOT / "hific_tpu", ROOT / "hific_tpu_torch"

# JAX module -> the port's module that holds its counterparts.
MODULE_MAP = {"ops/pallas_norm.py": "ops/fused_norm.py"}
# ... and the port's kernel source behind it.
KERNEL_SOURCES = {"ops/pallas_norm.py": "csrc/channel_norm.cu"}

_FLAX_SETUP = ("Flax's `setup` declares submodules; a torch module does "
               "that in `__init__`")
_JIT_BOUNDARY = ("an `apply(method=)` entry of the JAX `Codec`'s jitted "
                 "programs (and its packed uint8 wire); the port's codec "
                 "calls the submodules eagerly, in `HiFiC.compress_front`, "
                 "`synth_stats`, `latent_symbols` and `generate`")
_SHARDING = ("a `jax.sharding` placement; the port's data parallelism is "
             "DDP (`training/train_step.data_parallel_`) with rows taken "
             "by `mesh.shard_rows`")
_PARAM_TWIN = ("a Flax parameter-tree twin that lets a rewritten compute "
               "path share the checkpoint tree; a torch module holds its "
               "own parameters, which the rewrites read")
_LPIPS_FACTORY = ("a JAX LPIPS factory over parameter trees; the port's "
                  "counterparts are the modules `default_lpips` / "
                  "`load_lpips` build")
_PACKED_DECODE = ("the JAX device decoder's single-upload layout for its "
                  "accelerator's wire; the port's kernels read "
                  "`entropy/rans_tables.RansTables` and `words_tensor`")

NO_COUNTERPART = {
    "cli/compress.py:save_png": "the port's tools write PNGs with "
                                "`utils/image_io.write_png`",
    "cli/train.py:make_lpips_apply": _LPIPS_FACTORY,
    "config.py:ModelModes": ("the `mode=` strings of the JAX "
                             "`HiFiC.__call__`; the port's `forward` takes "
                             "`training=`, and its evaluation is the "
                             "codec's"),
    "entropy/device_decode.py:DeviceTables": _PACKED_DECODE,
    "entropy/device_decode.py:build_device_tables": _PACKED_DECODE,
    "entropy/device_decode.py:pack_decode_input": _PACKED_DECODE,
    "entropy/device_decode.py:stream_bucket": "pads uploads to bucketed "
                                              "lengths to bound XLA "
                                              "recompiles; eager kernels "
                                              "take any length",
    "entropy/device_decode.py:unpack_decode_input": _PACKED_DECODE,
    "entropy/native.py:available": "the port's native coder is loaded by "
                                   "`native.enabled()` and built by "
                                   "`native_build.py`",
    "entropy/native.py:get_lib": "the port's native coder is loaded by "
                                 "`native.enabled()` and built by "
                                 "`native_build.py`",
    "entropy/native.py:pmf_to_quantized_cdf_native": (
        "a C copy of `ops/maths.pmf_to_quantized_cdf` that no path of the "
        "JAX package calls; both packages' tables quantize in numpy"),
    "entropy/tables.py:estimate_tails": ("a `lax.while_loop` over a JAX "
                                         "callable; the port runs the same "
                                         "search in numpy, "
                                         "`host_math.factorized_tails`"),
    "models/density.py:HyperlatentDensity.setup": _FLAX_SETUP,
    "models/hific.py:HiFiC.setup": _FLAX_SETUP,
    "models/hific.py:HiFiC.compress_symbols": _JIT_BOUNDARY,
    "models/hific.py:HiFiC.compress_symbols_from_latents": _JIT_BOUNDARY,
    "models/hific.py:HiFiC.compress_symbols_packed": _JIT_BOUNDARY,
    "models/hific.py:HiFiC.compress_symbols_packed_from_latents":
        _JIT_BOUNDARY,
    "models/hific.py:HiFiC.discriminator_forward": (
        "an `apply(method=)` entry; the port's is the module function "
        "`models/hific.discriminator_forward`"),
    "models/hific.py:HiFiC.encoder_forward": _JIT_BOUNDARY,
    "models/hific.py:HiFiC.generate_from_symbols": _JIT_BOUNDARY,
    "models/hific.py:HiFiC.generate_u8_from_packed_symbols": _JIT_BOUNDARY,
    "models/hific.py:HiFiC.generate_u8_from_symbols": _JIT_BOUNDARY,
    "models/hific.py:HiFiC.hyper_analyze": _JIT_BOUNDARY,
    "models/hific.py:HiFiC.hyper_synthesize": _JIT_BOUNDARY,
    "models/hific.py:HiFiC.hyperlatent_cdf_logits": _JIT_BOUNDARY,
    "models/hific.py:HiFiC.hyperlatent_likelihood_at": _JIT_BOUNDARY,
    "models/hific.py:HiFiC.latent_symbols_packed": _JIT_BOUNDARY,
    "models/hyperprior.py:Hyperprior.hyperlatent_likelihood": (
        "an `apply(method=)` entry; the port calls "
        "`hyperprior.hyperlatent_density`"),
    "models/hyperprior.py:Hyperprior.setup": _FLAX_SETUP,
    "models/hyperprior.py:HyperpriorDLMM.setup": _FLAX_SETUP,
    "models/layers.py:ConvParams": _PARAM_TWIN,
    "models/layers.py:ConvTransposeParams": _PARAM_TWIN,
    "models/layers.py:NormParams": _PARAM_TWIN,
    "models/layers.py:activation_fn": ("maps a name to a `jax.nn` function; "
                                       "the port's layers hold `nn.ReLU` "
                                       "modules"),
    "models/lpips.py:build_lpips_fn": _LPIPS_FACTORY,
    "models/lpips.py:default_lpips_params": _LPIPS_FACTORY,
    "models/lpips.py:load_lpips_npz": _LPIPS_FACTORY,
    "models/lpips.py:load_torch_lpips_weights": _LPIPS_FACTORY,
    "models/lpips.py:lpips_params_from_reference_state": _LPIPS_FACTORY,
    "parallel/mesh.py:batch_sharding": _SHARDING,
    "parallel/mesh.py:replicate": ("`jax.device_put` onto a replicated "
                                   "sharding; the port's spatial codec "
                                   "copies the model with "
                                   "`parallel/spatial.replicate`"),
    "parallel/mesh.py:replicate_sharding": _SHARDING,
    "parallel/mesh.py:shard_batch": _SHARDING,
    "parallel/mesh.py:shard_train_step": _SHARDING,
    "training/checkpoints.py:load_params_npz": ("builds a Flax parameter "
                                                "tree; the port loads the "
                                                "same file into a "
                                                "state_dict, "
                                                "`weights.load_npz`"),
    "training/checkpoints.py:restore_params": ("a Flax parameter tree from "
                                               "a checkpoint; the port "
                                               "restores modules, "
                                               "`restore_train_state`"),
    "training/train_step.py:split_params": ("splits one Flax variables "
                                            "dict; the port's codec, "
                                            "discriminator and spectral "
                                            "state are separate modules"),
}


def public_names(path: pathlib.Path) -> set:
    """Qualified public functions, classes and methods of a module."""
    names = set()

    def walk(body, prefix):
        for node in body:
            if isinstance(node, ast.If) and "__main__" in ast.unparse(
                    node.test):
                continue  # a script's own body, not the module's API
            if isinstance(node, (ast.If, ast.Try)):
                walk(node.body + node.orelse, prefix)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                   ast.ClassDef)):
                if node.name.startswith("_"):
                    continue
                names.add(prefix + node.name)
                if isinstance(node, ast.ClassDef):
                    walk(node.body, f"{prefix}{node.name}.")

    walk(ast.parse(path.read_text()).body, "")
    return names


def jax_modules() -> list:
    return sorted(str(p.relative_to(JAX)) for p in JAX.rglob("*.py"))


def without_counterpart() -> set:
    """`module:name` of every JAX public name the port's module lacks."""
    missing = set()
    for module in jax_modules():
        port = PORT / MODULE_MAP.get(module, module)
        ours = public_names(port) if port.exists() else set()
        missing |= {f"{module}:{name}"
                    for name in public_names(JAX / module) - ours}
    return missing


def test_every_jax_module_has_a_port_module():
    absent = [m for m in jax_modules()
              if not (PORT / MODULE_MAP.get(m, m)).exists()]
    assert absent == []
    for source in KERNEL_SOURCES.values():
        assert (PORT / source).exists(), source


def test_every_public_name_has_a_counterpart():
    unlisted = sorted(without_counterpart() - set(NO_COUNTERPART))
    assert unlisted == [], (
        "public names of hific_tpu/ with no counterpart in hific_tpu_torch/: "
        f"{unlisted}")


def test_no_counterpart_list_is_exact():
    """Every entry names a JAX public name the port lacks, with a
    reason."""
    stale = sorted(set(NO_COUNTERPART) - without_counterpart())
    assert stale == [], f"entries with a counterpart or no JAX name: {stale}"
    assert all(reason.strip() for reason in NO_COUNTERPART.values())
