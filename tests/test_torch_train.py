"""The port's training slice against the reference's, on the CPU, at the
smoke configs (float32): every family's ``train_loss`` and gradient against
``jax.value_and_grad`` of the reference's (its plain attention and
``wkv_ref``, ``REPRO_PALLAS`` unset), the backward kernels' plain versions
against ``jax.vjp`` of the reference's plain functions, the autograd
Functions' wiring, AdamW and the schedule, the data, the train step and
``train()``, and the CLI.

Weights come from the reference's ``init_params``, as numpy, through
``convert.from_reference``; RWKV's ``tmix.wo`` (and ``decay_w2``) are
redrawn, as its init of 0 would cut the WKV branch, K3 included, out of the
gradient."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS
from repro.launch import steps as ref_steps
from repro.models import api as ref_api
from repro.models import layers as ref_layers
from repro.models import ssm as ref_ssm
from repro.train import data as ref_data
from repro.train import optimizer as ref_opt
from repro_torch.configs import registry
from repro_torch.kernels import dispatch
from repro_torch.kernels.attention.ref import (flash_attention_bwd_ref,
                                               flash_attention_fwd_ref, flash_attention_ref)
from repro_torch.kernels.rwkv.ref import wkv6_bwd_ref, wkv6_ref
from repro_torch.launch import steps, train as train_cli
from repro_torch.models import api, convert
from repro_torch.models.common import tensor_leaves
from repro_torch.train import data, optimizer
from repro_torch.train.checkpoint import _flatten
from repro_torch.train.loop import batch_on, train

FAMILIES = ["deepseek-7b", "granite-moe-3b-a800m", "rwkv6-1.6b", "recurrentgemma-9b",
            "whisper-tiny", "llava-next-mistral-7b"]
LOSS_TOL = 1e-5    # float32, same functions: summation order only
GRAD_TOL = 1e-4    # relative L2 per leaf: gradients sum over every position
WIRING_TOL = 1e-5  # the Functions' explicit gradients vs autograd of the same forward
OPT_TOL = 1e-6     # AdamW on the same gradients: elementwise rounding only
STEP_TOL = 1e-4    # three steps of the whole model, relative L2 per leaf
ZERO_GRAD_SHARE = 1e-7   # a gradient that is 0 in exact arithmetic, against the whole


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _ref_tree(arch: str, seed: int = 0) -> dict:
    """The reference's smoke init as numpy; RWKV's ``tmix.wo`` and
    ``decay_w2`` redrawn from N(0, 1/d)."""
    cfg = ARCHS[arch].smoke
    tree = jax.tree_util.tree_map(np.array, ref_api.init_params(jax.random.PRNGKey(seed), cfg))
    if cfg.family == "ssm":
        rng = np.random.default_rng(seed + 100)
        tmix = tree["layers"]["tmix"]
        for leaf, key in ((tmix["wo"], "w"), (tmix, "decay_w2")):
            a = leaf[key]
            leaf[key] = (rng.standard_normal(a.shape) / np.sqrt(cfg.d_model)).astype(a.dtype)
    return tree


def _np_batch(arch: str, b: int = 2, s: int = 16, step: int = 0) -> dict:
    cfg = ARCHS[arch].smoke
    return {**ref_data.LMBatches(cfg.vocab_size, b, s, seed=0)(step),
            **ref_data.modal_extras(cfg, b, seed=0, step=step)}


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def _port_grads(params, batch, cfg):
    """-> (loss, metrics, the gradient tree in the reference's layout as numpy)."""
    for p in tensor_leaves(params):
        p.requires_grad_()
    loss, metrics = api.train_loss(params, batch, cfg)
    loss.backward()
    grads = convert.to_reference(_tree_map(lambda p: p.grad, params), cfg)
    return loss, metrics, _tree_map(lambda g: g.numpy(), grads)


# ----------------------------------------------------------------------
# each family's loss and gradient against the reference's
# ----------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_train_loss_and_every_gradient_match_the_reference(arch):
    ref_cfg, cfg = ARCHS[arch].smoke, registry.get(arch).smoke
    tree, nb = _ref_tree(arch), _np_batch(arch)
    ref_batch = {k: jnp.asarray(v, ref_cfg.cdt if v.dtype.kind == "f" else None)
                 for k, v in nb.items()}
    (want_loss, want_m), want_g = jax.value_and_grad(
        lambda p: ref_api.train_loss(p, ref_batch, ref_cfg), has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, tree))
    params = convert.from_reference(tree, cfg, "cpu")
    loss, metrics, grads = _port_grads(params, batch_on(nb, cfg, "cpu"), cfg)
    assert abs(loss.item() - float(want_loss)) <= LOSS_TOL * abs(float(want_loss))
    assert abs(metrics["aux"].item() - float(want_m["aux"])) <= LOSS_TOL * max(
        abs(float(want_m["aux"])), 1e-3)
    got_leaves = _flatten(grads)
    want_leaves = jax.tree_util.tree_flatten_with_path(want_g)[0]
    assert len(got_leaves) == len(want_leaves)
    total = np.sqrt(sum(np.sum(np.square(np.asarray(w))) for _, w in want_leaves))
    for g, (path, w) in zip(got_leaves, want_leaves):
        w = np.asarray(w)
        assert g.shape == w.shape
        if jax.tree_util.keystr(path).endswith("['wk']['b']"):
            # a key bias adds q.b to every logit of a row, which the softmax
            # cancels: its gradient is 0, and both sides hold rounding noise
            assert max(np.linalg.norm(g), np.linalg.norm(w)) <= ZERO_GRAD_SHARE * total
            continue
        # the + 1e-12 admits a leaf whose gradient is exactly 0 on both sides
        assert np.linalg.norm(g - w) <= GRAD_TOL * np.linalg.norm(w) + 1e-12


def test_the_rwkv_gradient_reaches_the_wkv_branch():
    """With ``tmix.wo`` redrawn the WKV inputs get a gradient (the init's 0
    would leave ``u`` and the r/k/v/w projections at exactly 0)."""
    cfg = registry.get("rwkv6-1.6b").smoke
    params = convert.from_reference(_ref_tree("rwkv6-1.6b"), cfg, "cpu")
    _, _, grads = _port_grads(params, batch_on(_np_batch("rwkv6-1.6b"), cfg, "cpu"), cfg)
    tmix = grads["layers"]["tmix"]
    for leaf in (tmix["u"], tmix["wr"]["w"], tmix["wk"]["w"], tmix["wv"]["w"], tmix["w0"]):
        assert np.abs(leaf).max() > 0


# ----------------------------------------------------------------------
# the backward kernels' plain versions against jax.vjp of the reference's
# plain functions
# ----------------------------------------------------------------------

def _randn(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("b,s,h,kh,hd,window", [
    (2, 40, 4, 4, 16, 0),     # causal MHA
    (2, 37, 4, 2, 16, 0),     # GQA, ragged
    (1, 48, 6, 2, 32, 0),     # GQA 3:1
    (2, 40, 4, 1, 16, 8),     # MQA, windowed
])
def test_flash_attention_bwd_plain_matches_vjp_of_the_reference_sdpa(b, s, h, kh, hd, window):
    q, k, v, do = (_randn(sh, i) for i, sh in enumerate(
        [(b, s, h, hd), (b, s, kh, hd), (b, s, kh, hd), (b, s, h, hd)]))
    pos = jnp.arange(s)
    mask = ref_layers.causal_window_mask(pos, pos, window)
    _, vjp = jax.vjp(lambda q_, k_, v_: ref_layers.sdpa(q_, k_, v_, mask), q, k, v)
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = flash_attention_fwd_ref(tq, tk, tv, window=window)
    got = flash_attention_bwd_ref(tq, tk, tv, o, tdo, lse, window=window)
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w) < WIRING_TOL


@pytest.mark.parametrize("b,t,h,hd,log_decay,final_grad", [
    (2, 7, 3, 4, -2.0, False),
    (2, 20, 2, 8, -2.0, True),     # a gradient on the final state
    (1, 19, 2, 8, 2.0, True),      # decays near 0
    (1, 24, 2, 8, -6.0, True),     # decays near 1
])
def test_wkv6_bwd_plain_matches_vjp_of_the_reference_wkv_ref(b, t, h, hd, log_decay,
                                                               final_grad):
    r, k, v = (_randn((b, t, h, hd), i) for i in range(3))
    w = np.exp(-np.exp(_randn((b, t, h, hd), 3) + log_decay)).astype(np.float32)
    u, s0 = _randn((h, hd), 4, 0.5), _randn((b, h, hd, hd), 5, 0.1)
    do = _randn((b, t, h, hd), 6)
    ds_t = _randn((b, h, hd, hd), 7) if final_grad else np.zeros((b, h, hd, hd), np.float32)
    _, vjp = jax.vjp(ref_ssm.wkv_ref, r, k, v, w, u, s0)
    want = vjp((jnp.asarray(do), jnp.asarray(ds_t)))
    got = wkv6_bwd_ref(*(torch.from_numpy(a) for a in (r, k, v, w, u, s0, do, ds_t)))
    for g, w_ in zip(got, want):
        assert _rel(g.numpy(), w_) < WIRING_TOL


# ----------------------------------------------------------------------
# the autograd Functions' wiring (their plain forward and backward on the CPU)
# ----------------------------------------------------------------------

@pytest.mark.parametrize("b,s,h,kh,hd,window", [(2, 37, 4, 2, 16, 0), (1, 50, 4, 1, 32, 8),
                                                (2, 64, 4, 4, 32, 0)])
def test_flash_attention_function_matches_autograd_of_the_plain_forward(b, s, h, kh, hd,
                                                                         window):
    ins = [torch.from_numpy(_randn(sh, i)).requires_grad_() for i, sh in
           enumerate([(b, s, h, hd), (b, s, kh, hd), (b, s, kh, hd)])]
    do = torch.from_numpy(_randn((b, s, h, hd), 3))
    out = dispatch.flash_attention(*ins, window=window)
    assert out.grad_fn is not None and type(out.grad_fn).__name__ == "FlashAttentionBackward"
    got = torch.autograd.grad(out, ins, do)
    want = torch.autograd.grad(flash_attention_ref(*ins, window=window), ins, do)
    for g, w in zip(got, want):
        assert _rel(g, w) < WIRING_TOL
    # only the inputs that need a gradient get one (the GQA sum in dk, dv)
    q = ins[0].detach().requires_grad_()
    out = dispatch.flash_attention(q, ins[1].detach(), ins[2].detach(), window=window)
    (gq,) = torch.autograd.grad(out, (q,), do)
    assert _rel(gq, want[0]) < WIRING_TOL


def test_wkv6_function_matches_autograd_of_the_plain_forward():
    b, t, h, hd = 2, 21, 3, 8
    arrays = [_randn((b, t, h, hd), i) for i in range(3)]
    arrays.append(np.exp(-np.exp(_randn((b, t, h, hd), 3) - 2.0)).astype(np.float32))
    arrays += [_randn((h, hd), 4, 0.5), _randn((b, h, hd, hd), 5, 0.1)]
    ins = [torch.from_numpy(a).requires_grad_() for a in arrays]
    do = torch.from_numpy(_randn((b, t, h, hd), 6))
    ds_t = torch.from_numpy(_randn((b, h, hd, hd), 7))
    o, s = dispatch.rwkv_scan(*ins)
    got = torch.autograd.grad((o, s), ins, (do, ds_t))
    want = torch.autograd.grad(wkv6_ref(*ins), ins, (do, ds_t))
    for g, w in zip(got, want):
        assert _rel(g, w) < WIRING_TOL
    # the final state unused: its gradient is zero, not missing
    o, _ = dispatch.rwkv_scan(*ins)
    got = torch.autograd.grad(o, ins, do)
    want = torch.autograd.grad(wkv6_ref(*ins)[0], ins, do)
    for g, w in zip(got, want):
        assert _rel(g, w) < WIRING_TOL


# ----------------------------------------------------------------------
# AdamW, the schedule, the data
# ----------------------------------------------------------------------

def test_adamw_and_cosine_schedule_match_the_reference_step_for_step():
    rng = np.random.default_rng(0)
    shapes = [(8, 16), (16,), (3, 4, 5)]
    p0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[(rng.standard_normal(s) * 0.7).astype(np.float32) for s in shapes]
             for _ in range(3)]
    sched, ref_sched = (m.cosine_schedule(1e-2, warmup=2, total=6)
                        for m in (optimizer, ref_opt))
    for step in range(8):
        assert abs(sched(step) - float(ref_sched(jnp.asarray(step)))) <= OPT_TOL * 1e-2
    opt, ref = optimizer.AdamW(learning_rate=sched), ref_opt.AdamW(learning_rate=ref_sched)
    params = [torch.from_numpy(p.copy()) for p in p0]
    ref_params = [jnp.asarray(p) for p in p0]
    state, ref_state = opt.init(params), ref.init(ref_params)
    for g in grads:
        params, state, m = opt.update(params, [torch.from_numpy(x) for x in g], state)
        ref_params, ref_state, rm = ref.update(ref_params, [jnp.asarray(x) for x in g],
                                               ref_state)
        assert abs(m["lr"] - float(rm["lr"])) <= OPT_TOL * abs(float(rm["lr"]))
        assert _rel(m["grad_norm"], rm["grad_norm"]) < OPT_TOL
        for got, want in ((params, ref_params), (state["mu"], ref_state["mu"]),
                          (state["nu"], ref_state["nu"])):
            for a, b in zip(got, want):
                assert _rel(a, b) < OPT_TOL
    assert state["step"] == int(ref_state["step"]) == 3


def test_adamw_keeps_float32_moments_and_the_param_dtype():
    params = [torch.ones((4, 4), dtype=torch.bfloat16)]
    opt = optimizer.AdamW(learning_rate=1e-2)
    state = opt.init(params)
    assert state["mu"][0].dtype == torch.float32 and state["nu"][0].dtype == torch.float32
    params, state, _ = opt.update(params, [torch.full((4, 4), 3.0, dtype=torch.bfloat16)],
                                  state)
    assert params[0].dtype == torch.bfloat16 and state["mu"][0].abs().max() > 0


@pytest.mark.parametrize("arch", ["deepseek-7b", "whisper-tiny", "llava-next-mistral-7b"])
def test_data_equals_the_reference_bit_for_bit(arch):
    cfg = ARCHS[arch].smoke
    for step in (0, 3):
        got = {**data.LMBatches(cfg.vocab_size, 3, 24, seed=5)(step),
               **data.modal_extras(cfg, 3, seed=5, step=step)}
        want = {**ref_data.LMBatches(cfg.vocab_size, 3, 24, seed=5)(step),
                **ref_data.modal_extras(cfg, 3, seed=5, step=step)}
        assert got.keys() == want.keys()
        for key in want:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])
    got, want = data.ImageBatches(2, 32, seed=1)(4), ref_data.ImageBatches(2, 32, seed=1)(4)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])


# ----------------------------------------------------------------------
# the train step, train() and the CLI
# ----------------------------------------------------------------------

@pytest.mark.parametrize("arch,num_micro", [("deepseek-7b", 1), ("deepseek-7b", 2),
                                            ("granite-moe-3b-a800m", 2)])
def test_train_step_matches_the_reference_jitted_step(arch, num_micro):
    ref_cfg, cfg = ARCHS[arch].smoke, registry.get(arch).smoke
    tree = _ref_tree(arch)
    sched = dict(warmup=1, total=3)
    ref = ref_opt.AdamW(learning_rate=ref_opt.cosine_schedule(1e-2, **sched))
    opt = optimizer.AdamW(learning_rate=optimizer.cosine_schedule(1e-2, **sched))
    ref_fn = jax.jit(ref_steps.make_train_step(ref_cfg, ref, num_micro=num_micro))
    step_fn = steps.make_train_step(cfg, opt, num_micro=num_micro)
    ref_params = jax.tree_util.tree_map(jnp.asarray, tree)
    ref_state = ref.init(ref_params)
    params = convert.from_reference(tree, cfg, "cpu")
    state = opt.init(params)
    for i in range(3):
        nb = _np_batch(arch, b=4, s=16, step=i)
        ref_params, ref_state, rm = ref_fn(ref_params, ref_state,
                                           {k: jnp.asarray(v) for k, v in nb.items()})
        params, state, m = step_fn(params, state, batch_on(nb, cfg, "cpu"))
        assert abs(float(m["loss"]) - float(rm["loss"])) <= LOSS_TOL * abs(float(rm["loss"]))
        assert set(m) == set(rm)
    got = _flatten(_tree_map(lambda t: t.detach().numpy(), convert.to_reference(params, cfg)))
    for g, w in zip(got, jax.tree_util.tree_leaves(ref_params)):
        assert _rel(g, w) < STEP_TOL


def test_choose_microbatch_matches_the_reference():
    for arch in ("deepseek-7b", "whisper-tiny"):
        for args in ((8, 64, 1), (256, 4096, 8), (32, 32768, 4)):
            assert steps.choose_microbatch(registry.get(arch).config, *args) == \
                ref_steps.choose_microbatch(ARCHS[arch].config, *args)


def test_train_loss_decreases():
    cfg = registry.get("deepseek-7b").smoke
    rep = train(cfg, steps=25, batch=4, seq=32, lr=1e-3, verbose=False, device="cpu")
    assert rep.final_loss < rep.initial_loss
    assert len(rep.losses) == 25 and rep.params_m > 0


def test_train_cli_runs_on_the_cpu(capsys):
    assert train_cli.main(["--arch", "rwkv6-1.6b", "--smoke", "--device", "cpu",
                           "--steps", "3", "--batch", "2", "--seq", "8"]) == 0
    out = capsys.readouterr().out
    assert "rwkv6-smoke" in out and "3 steps" in out


def test_train_cli_refuses_parallelism(capfd):
    """The hybrid family under a model axis, which the CLI refused before
    the sharded paths cut its recurrence and its one kv head: ``--arch
    recurrentgemma-9b --model-par 2`` now spawns two gloo ranks, whose
    losses equal the single-device run's within 1e-5 relative (the name is
    the one it had when it asserted the refusal)."""
    args = ["--arch", "recurrentgemma-9b", "--smoke", "--device", "cpu", "--steps", "3"]
    assert train_cli.main(args) == 0
    single = _cli_losses(capfd.readouterr().out)
    assert train_cli.main(args + ["--model-par", "2"]) == 0
    out = capfd.readouterr().out
    assert "mesh data=1 model=2: gloo" in out
    sharded = _cli_losses(out)
    assert len(single) == len(sharded) == 3
    for a, b in zip(sharded, single):
        assert abs(a - b) <= 1e-5 * abs(b)


def _cli_losses(out: str) -> list:
    line = next(x for x in out.splitlines() if x.startswith("[train] losses"))
    return [float(v) for v in line.split()[2:]]
