"""Sharded state (`--fsdp K`, parallel/mesh.py) against the JAX package's
(data, fsdp) mesh, without ranks: where each leaf lives and what a rank
holds.

  * Placement: for every parameter of G, D and the VGG, at tiny() and at
    full width and for K = 2 and 4, the port's `fsdp_dim` shards exactly
    the leaves the JAX package's `fsdp_spec` shards, on the same logical
    axis: the JAX shard's shape, carried from the flax layout into the
    torch one (conv HWIO -> OIHW, dense (in, out) -> (out, in)), is the
    port's shard's shape. The port's networks are built on the `meta`
    device, the JAX shapes come from `jax.eval_shape` of its
    `init_train_state`.
  * Bytes: a rank's parameters and Adam moments as `sharded_state_bytes`
    works them out at K = 2 equal the JAX package's per-device bytes after
    `shard_state` on `make_mesh(fsdp=2)` (its `addressable_shards`), at
    tiny(); and at full width, unsharded, the 1.10 GB of (29,967,047 +
    16,820,994) x 4 B x 3 + 135,755,949 x 4 B.
  * `make_mesh` raises, with the JAX package's words, when K does not
    divide the ranks (one process counts one).
The ranks themselves, the hold against the JAX FSDP step and the planted
faults are in tests/test_torch_fsdp_hold*.py.
"""

import functools

import jax
import pytest
import torch
from flax import traverse_util

from semantic_pyramid_for_image_generation_tpu.config import (
    PyramidGANConfig as JaxConfig,
)
from semantic_pyramid_for_image_generation_tpu.parallel import (
    FSDP_AXIS,
    fsdp_spec,
    make_mesh as jax_make_mesh,
    shard_state as jax_shard_state,
)
from semantic_pyramid_for_image_generation_tpu.parallel.mesh import (
    FSDP_MIN_LEAF_ELEMENTS as JAX_MIN_LEAF,
)
from semantic_pyramid_for_image_generation_tpu.train import state as jstate
from semantic_pyramid_for_image_generation_tpu.utils.pt_interop import (
    convert_discriminator_state_dict,
    convert_generator_state_dict,
    convert_vgg16_state_dict,
)
from semantic_pyramid_for_image_generation_torch.config import PyramidGANConfig
from semantic_pyramid_for_image_generation_torch.models.discriminator import (
    Discriminator,
)
from semantic_pyramid_for_image_generation_torch.models.generator import (
    Generator,
)
from semantic_pyramid_for_image_generation_torch.models.vgg16 import VGG16
from semantic_pyramid_for_image_generation_torch.parallel import mesh
from semantic_pyramid_for_image_generation_torch.train.state import (
    init_train_state,
    sharded_state_bytes,
)
from semantic_pyramid_for_image_generation_torch.utils.pt_interop import (
    discriminator_layout,
    generator_layout,
    vgg16_state_dict_keys,
)

# the torch dim of each flax axis (the test's own reading of the layouts)
TORCH_OF_FLAX = {"conv": (3, 2, 0, 1), "dense": (1, 0)}
WIDTHS = {"tiny": lambda c: c.tiny(), "full": lambda c: c}


def _meta_state(config: PyramidGANConfig):
    """G, D and the VGG on the `meta` device, as a state-like namespace."""
    import types

    with torch.device("meta"):
        nets = dict(generator=Generator(config),
                    discriminator=Discriminator(config), vgg=VGG16(config))
    nets["vgg"].requires_grad_(False)
    return types.SimpleNamespace(**nets)


@functools.lru_cache(maxsize=None)
def _jax_shapes(width: str) -> dict:
    """net -> {flax path: shape} of the JAX package's parameters."""
    g_tx, d_tx = jstate.make_optimizers(1e-5)
    state = jax.eval_shape(functools.partial(
        jstate.init_train_state, config=WIDTHS[width](JaxConfig()),
        g_tx=g_tx, d_tx=d_tx), jax.random.key(0))
    return {net: {path: tuple(leaf.shape) for path, leaf in
                  traverse_util.flatten_dict(tree, sep="/").items()}
            for net, tree in (("generator", state.g_params),
                              ("discriminator", state.d_params),
                              ("vgg", state.vgg_params))}


def _flax_paths() -> dict:
    """net -> {torch key: (flax path, layout kind)} of every parameter."""
    out = {}
    for net, layout in (("generator", generator_layout()),
                        ("discriminator", discriminator_layout())):
        out[net] = {key: (path, kind) for key, collection, path, kind
                    in layout.entries if collection == "params"}
    out["vgg"] = {}
    for key in vgg16_state_dict_keys():
        _, layer, index, leaf = key.split(".")
        out["vgg"][key] = (
            f"{layer}_{index}/{'kernel' if leaf == 'weight' else 'bias'}",
            "same" if leaf == "bias" else
            "conv" if layer == "features" else "dense")
    return out


def _local(shape, axis, k):
    shape = list(shape)
    if axis is not None:
        shape[axis] //= k
    return tuple(shape)


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("width", list(WIDTHS))
def test_the_port_shards_the_leaves_jax_shards_on_the_same_axis(width, k):
    assert mesh.FSDP_MIN_LEAF_ELEMENTS == JAX_MIN_LEAF
    jax_mesh = jax_make_mesh(fsdp=k)
    state = _meta_state(WIDTHS[width](PyramidGANConfig()))
    shapes, paths = _jax_shapes(width), _flax_paths()
    sharded = {net: 0 for net in shapes}
    for net in shapes:
        params = dict(getattr(state, net).named_parameters())
        assert set(params) == set(paths[net])
        for key, p in params.items():
            path, kind = paths[net][key]
            flax_shape = shapes[net][path]
            spec = tuple(fsdp_spec(flax_shape, jax_mesh))
            axis = spec.index(FSDP_AXIS) if FSDP_AXIS in spec else None
            jax_local = _local(flax_shape, axis, k)
            order = TORCH_OF_FLAX.get(kind, range(len(flax_shape)))
            want = tuple(jax_local[a] for a in order)
            dim = mesh.fsdp_dim(key, tuple(p.shape), k)
            assert _local(p.shape, dim, k) == want, (net, key, dim, spec)
            assert (dim is None) == (axis is None), (net, key)
            sharded[net] += dim is not None
    # every network has leaves of both kinds
    assert all(n > 0 for n in sharded.values()), sharded


def _jax_per_device_bytes(state) -> dict:
    """Bytes on one device of the JAX state's parameters (G, D, VGG) and
    Adam moments (mu, nu of G and D)."""
    def on_device(tree) -> int:
        return sum(leaf.addressable_shards[0].data.nbytes
                   for leaf in jax.tree.leaves(tree))

    params = sum(on_device(t) for t in (state.g_params, state.d_params,
                                        state.vgg_params))
    moments = sum(on_device(opt[0].mu) + on_device(opt[0].nu)
                  for opt in (state.g_opt_state, state.d_opt_state))
    return {"parameters": params, "adam_moments": moments}


def test_rank_bytes_are_the_jax_per_device_bytes():
    config = PyramidGANConfig().tiny()
    port = init_train_state(config, torch.device("cpu"), seed=0)
    g_tx, d_tx = jstate.make_optimizers(1e-5)
    state = jstate.init_train_state(
        jax.random.key(0), JaxConfig().tiny(), g_tx, d_tx,
        g_variables=convert_generator_state_dict(port.generator.state_dict()),
        d_variables=convert_discriminator_state_dict(
            port.discriminator.state_dict()),
        vgg_variables=convert_vgg16_state_dict(port.vgg.state_dict()))
    whole = _jax_per_device_bytes(state)
    halves = _jax_per_device_bytes(jax_shard_state(state,
                                                   jax_make_mesh(fsdp=2)))
    assert sharded_state_bytes(port, 1) == whole
    assert sharded_state_bytes(port, 2) == halves
    assert halves["parameters"] < whole["parameters"]
    assert halves["adam_moments"] < whole["adam_moments"]


def test_full_width_bytes_per_rank():
    state = _meta_state(PyramidGANConfig())
    whole = sharded_state_bytes(state, 1)
    assert whole == {"parameters": (29_967_047 + 16_820_994
                                    + 135_755_949) * 4,
                     "adam_moments": (29_967_047 + 16_820_994) * 4 * 2}
    assert sum(whole.values()) == 1_104_480_288
    halves = sharded_state_bytes(state, 2)
    for kind in whole:  # most of the bytes sit in sharded leaves
        assert whole[kind] / 2 < halves[kind] < 0.55 * whole[kind]


def test_make_mesh_raises_when_fsdp_does_not_divide_the_ranks():
    assert not mesh.is_distributed()
    for k in (2, 4):
        with pytest.raises(ValueError,
                           match=f"device count 1 not divisible by fsdp={k}"):
            mesh.make_mesh(k, "cpu")
    mesh.check_fsdp(1, 1)
    mesh.check_fsdp(2, 4)
    with pytest.raises(ValueError, match="device count 6 not divisible by "
                                         "fsdp=4"):
        mesh.check_fsdp(4, 6)
    with pytest.raises(RuntimeError, match="no process group"):
        mesh.make_mesh(1, "cpu")


def test_unsharded_modules_and_tensors_pass_through():
    state = init_train_state(PyramidGANConfig().tiny(), torch.device("cpu"))
    assert not mesh.is_sharded(state.generator)
    w = next(state.generator.parameters())
    assert mesh.full_tensor(w) is w and mesh.shard_like(w, w) is w
