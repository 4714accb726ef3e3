"""BigGAN-deep in the port (models/biggan_deep.py, train/biggan_deep.py, the
Trainer on a `BigGANDeepConfig`) against the plain reference
`tests/plain_biggan_deep.py`, on the CPU at `BigGANDeepConfig.tiny()` in
float32, on seeded random weights (the port's orthogonal init; the
attention's gamma at 0.5 so that its branch counts).

Every tolerance stands beside its reason. Two CPU effects set them:
  * the port keeps activations in channels_last memory, where the CPU's
    float32 reductions over (B, H, W) (batch statistics, and batch norm's
    backward sums) round more than the plain reference's NCHW ones; a batch
    norm's backward cancels most of what it sums, so G's gradients differ
    from a float64 computation by ~1e-3 of the median leaf, which the plain
    reference run in channels_last memory also shows (forward outputs agree
    to ~1e-6);
  * Adam with beta1 = 0 moves each element by about lr * sign(g) on its
    first step, so an element whose gradient lies within that round-off of
    zero takes either sign: the parameters' change over steps differs by up
    to 2 lr on those elements. Biases that a batch norm follows
    (conv1..conv3 of a GBlock) have a zero gradient, all round-off; leaves
    whose reference gradient is under LEAF_FLOOR of the median leaf's are
    left out of the gradient and change checks.

Also: two D updates per G update (the Adams' step counts), a checkpoint
save -> auto_resume -> step equal to an uninterrupted run bitwise (for the
SP-GAN's family too), the options BigGAN-deep refuses raised alike by the
CLI and the Trainer from its family's one list, the bfloat16 program
inside a band of the float32 reference and outside the float32 tolerances, the SP-GAN's
`SelfAttention` and Trainer step as they were (keys, init, forward and step
bitwise), the benchmark's copy of the reference bitwise the plain one, and
the imports of both references.
"""

import ast
import dataclasses
import statistics
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import plain_biggan_deep as plain
from semantic_pyramid_for_image_generation_torch.config import (
    BigGANDeepConfig,
    PyramidGANConfig,
)
from semantic_pyramid_for_image_generation_torch.data.synthetic import (
    synthetic_batch,
)
from semantic_pyramid_for_image_generation_torch.models import biggan_deep as M
from semantic_pyramid_for_image_generation_torch.models.layers import (
    PooledKVAttentionFunction,
    SelfAttention,
    _rows,
    initialize_,
)
from semantic_pyramid_for_image_generation_torch.ops.pool import max_pool_2d
from semantic_pyramid_for_image_generation_torch.train import biggan_deep as B
from semantic_pyramid_for_image_generation_torch.train.loop import (
    Trainer,
    step_generator,
)
from semantic_pyramid_for_image_generation_torch.train.step import (
    batch_to_device,
    make_train_step,
)

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
CFG = BigGANDeepConfig(ema_start=0, attention_gamma=0.5).tiny()
PLAIN_CFG = dataclasses.asdict(CFG)
ROWS = 4  # per D update and per G update
STEPS = 3
LEAF_FLOOR = 1e-3
# float32, same arithmetic in another summation order: a forward through
# 12 blocks agrees to ~2e-6, one layer's forward and backward to ~6e-7
# (a GBlock's gains and biases run as one batched product); a parameter
# gradient by leaf against max(leaf, median leaf), since the biases that a
# batch norm follows have a gradient of round-off alone
FORWARD_TOL = 1e-5
LAYER_TOL = 1e-6
# three steps' losses (observed <= 2e-4: the hinge losses sit on G's and
# D's changed weights, see the module docstring)
LOSS_TOL = 1e-3
# the first step's gradients by leaf, against max(leaf, median leaf)
# (observed <= 3.5e-3: G's backward through 48 batch norms)
GRAD_TOL = 1e-2
# the change of G's / D's parameters over the three steps, by leaf as the
# norm of the difference against max(the reference's, the median leaf's)
# (observed <= 0.09 / 0.02: Adam's sign on round-off gradients)
G_CHANGE_TOL, D_CHANGE_TOL = 0.25, 0.05
# G_ema's change: (1 - decay) of G's, so G's tolerance and a little more
# for its u/v and running statistics (observed <= 0.22)
EMA_CHANGE_TOL = 0.35
# u, v and running statistics after three steps, relative (observed 4e-5)
STATE_TOL = 1e-3


def _state(seed: int = 3, dtype: str = "float32") -> B.BigGANDeepState:
    return B.init_state(dataclasses.replace(CFG, compute_dtype=dtype), CPU,
                        seed)


def _weights(module: torch.nn.Module) -> dict:
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def _draws(seed: int, rows: int = ROWS) -> list:
    """The (z, y) of each D update, then of the G update, in the step's
    documented order: z then y, from one generator."""
    rng = torch.Generator().manual_seed(seed)
    out = []
    for _ in range(CFG.num_d_steps + 1):
        z = torch.randn((rows, CFG.dim_z), generator=rng)
        y = torch.randint(0, CFG.num_classes, (rows,), generator=rng)
        out.append((z, y))
    return out


def _batches(n: int = STEPS, seed: int = 5) -> list:
    rng = torch.Generator().manual_seed(seed)
    rows = ROWS * CFG.num_d_steps
    return [{"images": torch.randint(0, 256, (rows, 64, 64, 3),
                                     dtype=torch.uint8, generator=rng),
             "labels": torch.randint(0, CFG.num_classes, (rows,),
                                     generator=rng)} for _ in range(n)]


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.detach().double(), want.detach().double()
    return float((got - want).norm()
                 / want.norm().clamp(min=1e-30))


def _leaf_gaps(got: dict, want: dict, keys) -> dict:
    """Per leaf ||got - want|| / max(||want||, median leaf's ||want||)."""
    keys = list(keys)
    median = statistics.median(float(want[k].double().norm()) for k in keys)
    return {k: float((got[k].double() - want[k].double()).norm())
            / max(float(want[k].double().norm()), median) for k in keys}


def _moved(grads: dict) -> list:
    """The leaves whose gradient is at least LEAF_FLOOR of the median's."""
    norms = {k: float(g.norm()) for k, g in grads.items()}
    median = statistics.median(norms.values())
    return [k for k, n in norms.items() if n >= LEAF_FLOOR * median]


# ------------------------------------------------------------ forwards --

@pytest.mark.parametrize("net", ["generator", "discriminator"])
def test_forward_matches_plain(net):
    state = _state()
    z, y = _draws(11)[0]
    module = getattr(state, net)
    weights = _weights(module)
    params, s_in = plain.split(weights)
    f = plain.Forward(params, s_in, True, PLAIN_CFG)
    w = plain.Widths(PLAIN_CFG)
    with plain.exact_float32():
        if net == "generator":
            got, want = module(z, y), plain.generator_forward(f, w, z, y)
        else:
            x = torch.rand((ROWS, 3, 64, 64),
                           generator=torch.Generator().manual_seed(2)) * 2 - 1
            got, want = module(x, y), plain.discriminator_forward(f, w, x, y)
    assert got.shape == want.shape
    assert _rel(got, want) <= FORWARD_TOL
    advanced = module.state_dict()
    for key, value in f.s_out.items():  # every u/v and batch statistic
        assert _rel(advanced[key], value) <= FORWARD_TOL, key


def _layer(kind: str):
    """(port module, plain function of (Forward, name, x, cond), input
    shape) of one layer kind at the tiny widths."""
    if kind == "ccbn":
        return (M.ConditioningBatchNorm(16, CFG),
                lambda f, n, x, c: f.ccbn(n, x, c), (ROWS, 16, 8, 8))
    if kind in ("gblock", "gblock_up"):
        up = kind == "gblock_up"
        out = 16 if up else 32
        return (M.GBlock(32, out, up, CFG),
                lambda f, n, x, c: plain.gblock(f, n, x, c, out, up),
                (ROWS, 32, 8, 8))
    if kind in ("dblock", "dblock_down"):
        down = kind == "dblock_down"
        cin = 16 if down else 32
        return (M.DBlock(cin, 32, down, CFG),
                lambda f, n, x, c: plain.dblock(f, n, x, down, cin != 32),
                (ROWS, cin, 8, 8))
    return (M.attention(CFG, 32), lambda f, n, x, c: f.attention(n, x),
            (ROWS, 32, 8, 8))


@pytest.mark.parametrize("kind", ["ccbn", "gblock", "gblock_up", "dblock",
                                  "dblock_down", "attention"])
def test_layer_matches_plain(kind):
    module, reference, shape = _layer(kind)
    M.orthogonal_init_(module, torch.Generator().manual_seed(4))
    if kind == "attention":
        with torch.no_grad():
            module.gamma.fill_(0.5)
    module.train()
    weights = {f"m.{k}": v for k, v in _weights(module).items()}
    rng = torch.Generator().manual_seed(6)
    x = torch.randn(shape, generator=rng).contiguous(
        memory_format=torch.channels_last).requires_grad_(True)
    cond = torch.randn((ROWS, CFG.cond_dim), generator=rng)
    got = module(x, cond) if kind in ("ccbn", "gblock", "gblock_up") else (
        module(x))
    probe = torch.randn(got.shape, generator=rng)
    got_grads = torch.autograd.grad((got * probe).sum(),
                                    [x] + list(module.parameters()))
    params, s_in = plain.split(weights)
    x_plain = x.detach().clone().requires_grad_(True)
    want = reference(plain.Forward(params, s_in, True, PLAIN_CFG), "m",
                     x_plain, cond)
    want_grads = torch.autograd.grad(
        (want * probe).sum(),
        [x_plain] + [params[f"m.{k}"] for k, _ in module.named_parameters()])
    assert _rel(got, want) <= LAYER_TOL
    assert _rel(got_grads[0], want_grads[0]) <= LAYER_TOL  # the input's
    names = [k for k, _ in module.named_parameters()]
    gaps = _leaf_gaps(dict(zip(names, got_grads[1:])),
                      dict(zip(names, want_grads[1:])), names)
    assert max(gaps.values()) <= LAYER_TOL, max(gaps, key=gaps.get)


def test_hinge_losses_match_plain():
    from semantic_pyramid_for_image_generation_torch.train.losses import (
        hinge_discriminator_loss,
        hinge_generator_loss,
    )

    rng = torch.Generator().manual_seed(8)
    fake, real = (torch.randn((8, 1), generator=rng) * 2 for _ in range(2))
    assert torch.equal(torch.stack(hinge_discriminator_loss(fake, real)),
                       torch.stack(plain.hinge_discriminator(fake, real)))
    assert torch.equal(hinge_generator_loss(fake),
                       plain.hinge_generator(fake))
    # the hinge: a real score past +1 and a fake one past -1 cost nothing
    zero = torch.stack(hinge_discriminator_loss(torch.full((2, 1), -3.0),
                                                torch.full((2, 1), 3.0)))
    assert torch.equal(zero, torch.zeros(2))


# ------------------------------------------------------------ steps --

def _run_both(state: B.BigGANDeepState, steps: int = STEPS):
    """`steps` port steps and plain steps on the same batches and draws;
    returns (port metrics, plain losses) per step and the plain trainer."""
    ref = plain.Trainer(PLAIN_CFG, _weights(state.generator),
                        _weights(state.discriminator))
    step = B.make_train_step()
    got, want = [], []
    for i, batch in enumerate(_batches(steps)):
        _, metrics = step(state, batch, torch.Generator().manual_seed(100 + i))
        got.append(torch.stack([metrics[k] for k in plain.LOSS_NAMES]))
        with plain.exact_float32():
            want.append(ref.step(batch["images"], batch["labels"],
                                 _draws(100 + i)))
        if i == 0:
            first = {"generator": {k: p.grad.clone() for k, p in
                                   state.generator.named_parameters()},
                     "discriminator": {k: p.grad.clone() for k, p in
                                       state.discriminator.named_parameters()},
                     "plain_generator": dict(ref.g_grads),
                     "plain_discriminator": dict(ref.d_grads[-1]),
                     "fakes": (ref.fakes[0],)}
    return got, want, ref, first


@pytest.fixture(scope="module")
def three_steps():
    state = _state()
    start = {"generator": _weights(state.generator),
             "discriminator": _weights(state.discriminator)}
    got, want, ref, first = _run_both(state)
    return state, start, got, want, ref, first


def test_three_steps_losses(three_steps):
    _, _, got, want, _, _ = three_steps
    for g, w in zip(got, want):
        assert float(((g - w).abs() / w.abs().clamp(min=1.0)).max()) \
            <= LOSS_TOL, (g, w)


@pytest.mark.parametrize("net", ["generator", "discriminator"])
def test_three_steps_first_gradients(three_steps, net):
    _, _, _, _, _, first = three_steps
    want = first[f"plain_{net}"]
    gaps = _leaf_gaps(first[net], want, _moved(want))
    assert max(gaps.values()) <= GRAD_TOL, max(gaps, key=gaps.get)


@pytest.mark.parametrize("net", ["generator", "discriminator"])
def test_three_steps_parameters_and_state(three_steps, net):
    state, start, _, _, ref, first = three_steps
    got, want = getattr(state, net).state_dict(), ref.state(net)
    assert set(got) == set(want)
    moved = _moved(first[f"plain_{net}"])
    change = lambda sd: {k: sd[k] - start[net][k] for k in moved}  # noqa: E731
    gaps = _leaf_gaps(change(got), change(want), moved)
    tol = G_CHANGE_TOL if net == "generator" else D_CHANGE_TOL
    assert max(gaps.values()) <= tol, max(gaps, key=gaps.get)
    for key in want:
        if plain.is_state(key) and want[key].is_floating_point():
            assert _rel(got[key], want[key]) <= STATE_TOL, key


def test_three_steps_ema(three_steps):
    state, start, _, _, ref, _ = three_steps
    got, want = state.generator_ema.state_dict(), ref.state("ema")
    keys = [k for k in want if want[k].is_floating_point()]
    change = lambda sd: {k: sd[k] - start["generator"][k]  # noqa: E731
                         for k in keys}
    moved = _moved(change(want))
    gaps = _leaf_gaps(change(got), change(want), moved)
    assert max(gaps.values()) <= EMA_CHANGE_TOL, max(gaps, key=gaps.get)
    # the decay applied, not a copy of G: G_ema stays near its start
    g_change = _leaf_gaps(got, start["generator"], keys)
    assert statistics.median(g_change.values()) < 1e-3


def test_update_counter_is_two_d_updates_per_g_update():
    """Two steps take four D updates and two G updates: the Adams count
    them."""
    state = _state(seed=9)
    step = B.make_train_step()
    for i, batch in enumerate(_batches(2)):
        step(state, batch, torch.Generator().manual_seed(i))
    assert state.step == 2
    d_steps = {int(s["step"]) for s in state.d_optimizer.state.values()}
    g_steps = {int(s["step"]) for s in state.g_optimizer.state.values()}
    assert d_steps == {4} and g_steps == {2}


def _trainer(tmp_path, name, config=CFG, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the random-init FID warning
        return Trainer(config, [], device=CPU, seed=7, allow_random_fid=True,
                       save_data_path=str(tmp_path / name), **kw)


def _resume_case(family: str):
    """A family's tiny config, its host batches and its saved networks."""
    if family == "biggan-deep":
        return (CFG, [{k: v.numpy() for k, v in b.items()}
                      for b in _batches()],
                ("generator", "discriminator", "generator_ema"))
    cfg = PyramidGANConfig().tiny()
    rng = np.random.default_rng(11)
    return (cfg, [synthetic_batch(cfg, 2, rng) for _ in range(STEPS)],
            ("generator", "discriminator"))


@pytest.mark.parametrize("family", ["biggan-deep", "sp-gan"])
def test_checkpoint_save_restore_step_is_bitwise(tmp_path, family):
    """A step, `save_checkpoint`, `auto_resume` in a fresh Trainer and the
    other steps end where an uninterrupted run does, bitwise, through the
    one family seam (train/family.py)."""
    config, batches, nets = _resume_case(family)
    straight = _trainer(tmp_path, "a", config)
    for batch in batches:
        straight.train_step(batch)
    first = _trainer(tmp_path, "b", config)
    first.train_step(batches[0])
    path = first.save_checkpoint(0)
    resumed = _trainer(tmp_path, "c", config)
    assert resumed.auto_resume(str(Path(path).parent))
    assert resumed.state.step == 1
    for batch in batches[1:]:
        resumed.train_step(batch)
    assert resumed.state.step == straight.state.step == STEPS
    for net in nets:
        a = getattr(straight.state, net).state_dict()
        b = getattr(resumed.state, net).state_dict()
        assert all(torch.equal(a[k], b[k]) for k in a), net
    for opt in ("g_optimizer", "d_optimizer"):
        a = getattr(straight.state, opt).state_dict()["state"]
        b = getattr(resumed.state, opt).state_dict()["state"]
        assert all(torch.equal(a[i][m], b[i][m]) for i in a
                   for m in ("exp_avg", "exp_avg_sq", "step")), opt


def test_bfloat16_inside_a_band_and_outside_float32():
    """bfloat16 compute (float32 parameters) against the float32 reference:
    the first step's losses and first fakes within a band that float8 or a
    wrong step would leave (1e-1), and outside the float32 tolerances
    (observed losses 5e-3 to 2e-2, G's gradients 0.4 of the median leaf)."""
    state = _state(dtype="bfloat16")
    first_fakes = []
    hook = state.generator.register_forward_hook(
        lambda m, a, out: first_fakes.append(out.detach().float()))
    got, want, _, first = _run_both(state, steps=1)
    hook.remove()
    losses = float(((got[0] - want[0]).abs() / want[0].abs().clamp(
        min=1.0)).max())
    fakes = _rel(first_fakes[0], first["fakes"][0])
    assert LOSS_TOL < losses <= 0.1
    assert FORWARD_TOL < fakes <= 0.1
    grads = _leaf_gaps(first["generator"], first["plain_generator"],
                       _moved(first["plain_generator"]))
    assert max(grads.values()) > GRAD_TOL


# ------------------------------------------------------------ the SP-GAN --

def test_self_attention_defaults_are_the_sp_gans():
    """SelfAttention(c)'s keys, init and forward as the SP-GAN has them:
    biases, gamma 1, x pooled before the key and value projections (the
    forward written out as it stood before the BigGAN form)."""
    c = 32
    attention = SelfAttention(c)
    assert list(attention.state_dict()) == [
        "gamma"] + [f"{conv}_convolution.{k}"
                    for conv in ("query", "key", "value", "attention")
                    for k in ("weight_orig", "bias", "weight_u", "weight_v")]
    assert torch.equal(attention.gamma, torch.ones(1))
    initialize_(attention, torch.Generator().manual_seed(1))
    with torch.no_grad():
        attention.gamma.fill_(0.7)
        for conv in (attention.query_convolution, attention.key_convolution,
                     attention.value_convolution,
                     attention.attention_convolution):
            conv.bias.normal_(generator=torch.Generator().manual_seed(2))
    attention.initialize()
    assert torch.equal(attention.gamma.detach(), torch.ones(1))
    attention.train()
    x = torch.randn((2, c, 8, 8), generator=torch.Generator().manual_seed(3)
                    ).contiguous(memory_format=torch.channels_last)
    twin = SelfAttention(c)
    twin.load_state_dict(attention.state_dict())
    twin.train()
    got = attention(x)
    pooled = max_pool_2d(x)
    q = _rows(twin.query_convolution(x))
    k = _rows(twin.key_convolution(pooled))
    v = _rows(twin.value_convolution(pooled))
    out = PooledKVAttentionFunction.apply(q, k, v).reshape(
        2, 8, 8, c // 2).permute(0, 3, 1, 2)
    want = twin.gamma * twin.attention_convolution(out) + x
    assert torch.equal(got, want)
    assert all(torch.equal(a, b) for a, b in zip(
        attention.state_dict().values(), twin.state_dict().values()))


def test_sp_gan_trainer_step_is_its_step_function(tmp_path):
    """The Trainer on a PyramidGANConfig runs `make_train_step` on
    `batch_to_device` with `step_generator`'s latents, bitwise."""
    cfg = PyramidGANConfig().tiny()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        trainer = Trainer(cfg, [], device=CPU, seed=4, lr=1e-4,
                          save_data_path=str(tmp_path), allow_random_fid=True,
                          write_grids=False)
        twin = Trainer(cfg, [], device=CPU, seed=4, lr=1e-4,
                       save_data_path=str(tmp_path), allow_random_fid=True,
                       write_grids=False)
    batch = synthetic_batch(cfg, 2, np.random.default_rng(0))
    got = trainer.train_step(batch)
    _, want = make_train_step()(
        twin.state, batch_to_device(batch, CPU), step_generator(5, 0, CPU))
    assert all(torch.equal(got[k], want[k]) for k in want)
    for net in ("generator", "discriminator"):
        a = getattr(trainer.state, net).state_dict()
        b = getattr(twin.state, net).state_dict()
        assert all(torch.equal(a[k], b[k]) for k in a), net
    assert trainer.logger.hyperparameter["lr"] == "0.0001"


# ------------------------------------------------------------ references --

def test_benchmark_reference_is_bitwise_the_plain():
    from benchmark.reference import biggan_deep as bench_ref

    state = _state(seed=12)
    g, d = _weights(state.generator), _weights(state.discriminator)
    batch = _batches(1, seed=13)[0]
    ours = plain.Trainer(PLAIN_CFG, g, d)
    theirs = bench_ref.BigGANDeepTrainer(PLAIN_CFG, g, d, remat=False)
    with plain.exact_float32():
        a = ours.step(batch["images"], batch["labels"], _draws(21))
        b = theirs.step(batch["images"], batch["labels"], _draws(21))
    assert torch.equal(a, b)
    assert torch.equal(ours.fakes[0], theirs.first_output)
    for key, value in ours.state("generator").items():
        assert torch.equal(value, theirs.generator_state()[key]), key
    for key, value in ours.ema.items():
        assert torch.equal(value, theirs.ema[key]), key
    for net, grads in (("generator", ours.g_grads),
                       ("discriminator", ours.d_grads[0])):
        assert all(torch.equal(grads[k], theirs.first_grads[net][k])
                   for k in grads), net


@pytest.mark.parametrize("path", ["tests/plain_biggan_deep.py",
                                  "benchmark/reference/biggan_deep.py"])
def test_reference_imports_neither_the_port_nor_jax(path):
    tree = ast.parse((REPO / path).read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    assert not names & {"jax", "jaxlib", "flax", "optax",
                        "semantic_pyramid_for_image_generation_tpu",
                        "semantic_pyramid_for_image_generation_torch"}, names


# ------------------------------------------------------------ the CLI --

# each option a family may refuse: its flags, and the Trainer's keywords
# (None: a field of the SP-GAN's config, not a Trainer option)
REFUSABLE = {
    "multihost": (["--multihost"], {}),  # the Trainer reads world_size()
    "fsdp": (["--fsdp", "2"], {"fsdp": 2}),
    "fused_discriminator": (["--fused_d"], {"fused_discriminator": True}),
    "remat_vgg": (["--remat_vgg"], {"remat_vgg": True}),
    "remat_blocks": (["--remat_blocks"], None)}


@pytest.mark.parametrize("option", list(REFUSABLE))
@pytest.mark.parametrize("arch", ["semantic-pyramid", "biggan-deep-256"])
def test_cli_and_trainer_refuse_from_the_familys_one_list(arch, option,
                                                          tmp_path,
                                                          monkeypatch):
    """`check_supported` and `Trainer(...)` raise the same message for each
    option that `--arch`'s family refuses; the lookup passes the others."""
    from semantic_pyramid_for_image_generation_torch.cli import main as cli
    from semantic_pyramid_for_image_generation_torch.train import loop
    from semantic_pyramid_for_image_generation_torch.train.family import (
        family_of,
    )

    flags, trainer_options = REFUSABLE[option]
    args = cli.build_parser().parse_args(["--arch", arch, *flags])
    config = cli.config_from_args(args)
    family = family_of(config)
    if option not in family.refuses:
        assert family_of(config, **{option: True}) is family
        return
    message = f"{family.refusal}; refused: {option}"
    with pytest.raises(ValueError) as raised:
        cli.check_supported(args)
    assert str(raised.value) == message
    if trainer_options is None:
        return
    monkeypatch.setattr(loop, "world_size",
                        lambda: 2 if option == "multihost" else 1)
    with pytest.raises(ValueError) as raised:
        _trainer(tmp_path, "r", **trainer_options)
    assert str(raised.value) == message


def test_cli_asks_for_the_image_folder_before_it_touches_a_device(
        monkeypatch):
    """A BigGAN-deep command line without `--image_folder` fails in
    `check_supported`, before `build_trainer` resolves a device."""
    from semantic_pyramid_for_image_generation_torch.cli import main as cli
    from semantic_pyramid_for_image_generation_torch.utils import device

    def touched(*args, **kwargs):
        raise AssertionError("a device was resolved")

    monkeypatch.setattr(device, "resolve_device", touched)
    args = cli.build_parser().parse_args(["--arch", "biggan-deep-256"])
    for call in (cli.check_supported, cli.build_trainer):
        with pytest.raises(ValueError, match="--image_folder"):
            call(args)


def test_trainer_refuses_what_biggan_deep_does_not_run(tmp_path):
    for kw in ({"fsdp": 2}, {"remat_vgg": True},
               {"fused_discriminator": True}):
        with pytest.raises(ValueError, match="BigGAN-deep trains on one"):
            _trainer(tmp_path, "r", **kw)
    trainer = _trainer(tmp_path, "s")
    with pytest.raises(ValueError, match="SP-GAN's"):
        trainer.generate({})
    from semantic_pyramid_for_image_generation_torch.models.vgg16 import VGG16
    from semantic_pyramid_for_image_generation_torch.serving import export

    generator = trainer.state.generator_ema
    with pytest.raises(ValueError, match="BigGAN-deep has no serving path"):
        export.save_artifact(generator, VGG16(PyramidGANConfig().tiny()),
                             str(tmp_path / "artifact"))


def test_cli_trains_validates_and_resumes(tmp_path, monkeypatch, capsys):
    """`--arch biggan-deep-256` on a class-folder tree, through the
    Trainer (the config patched to tiny(): 64x64, ch 8): trains an epoch,
    validates G_ema's FID, writes the grid and a checkpoint, then resumes
    from it."""
    from PIL import Image

    from semantic_pyramid_for_image_generation_torch import config
    from semantic_pyramid_for_image_generation_torch.cli import main as cli

    real = config.BigGANDeepConfig
    monkeypatch.setattr(config, "BigGANDeepConfig",
                        lambda **kw: real(**kw).tiny())
    rng = np.random.default_rng(0)
    for split in ("train", "val"):
        for cls in ("ant", "bee"):
            (tmp_path / "tree" / split / cls).mkdir(parents=True)
            for i in range(4):
                Image.fromarray(rng.integers(0, 255, (70, 64, 3),
                                             dtype=np.uint8)).save(
                    tmp_path / "tree" / split / cls / f"{i}.png")
    argv = ["--arch", "biggan-deep-256", "--image_folder",
            str(tmp_path / "tree"), "--device", "cpu", "--dtype", "float32",
            "--batch_size", "2", "--epochs", "1", "--allow_random_fid",
            "--fid_images", "2", "--fid_device_stats", "--num_workers", "2",
            "--save_data_path", str(tmp_path / "sd"),
            "--validate_after_n_iterations", "1000000"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert cli.main(argv + ["--train", "--test"]) == 0
        assert "FID=" in capsys.readouterr().out
        (checkpoint,) = (tmp_path / "sd").glob("models_*/checkpoint_000.pt")
        assert list((tmp_path / "sd").glob("plots_*/predictions_*.png"))
        trainer = cli.build_trainer(cli.build_parser().parse_args(
            argv + ["--load_checkpoint", str(checkpoint)]))
    assert trainer.state.step == 2  # 8 images, 4 a step (2 D updates of 2)
    with pytest.raises(ValueError, match="refused: fsdp"):
        cli.check_supported(cli.build_parser().parse_args(
            argv + ["--fsdp", "2"]))
