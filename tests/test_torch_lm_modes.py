"""Port parity, a bf16 language model's round in every consensus mode and the
scan driver on the reference's batch trees, on the CPU.

- one round of reduced smollm-135m (bf16, one type), rwkv6-7b and
  zamba2-2.7b (bf16 with float32 leaves beside them: the float32 block,
  ``ParamLayout.wide``) under push-sum (a directed ring), the qint8 and
  top-k wires, bounded staleness (bound 2, the straggler profile) and
  adaptive selection, against the reference's ``make_round_fn`` round from
  the same initial leaves and token batches: params, d, and the mode's own
  buffers (push-sum's mass, the estimates, the published snapshots, the
  selection's key and losses), every leaf in the reference's type; the bf16
  leaves within 5e-2 (tests/test_kernels.py's bf16 tolerance), each float32
  leaf's move within 5e-2 of the reference's (as
  tests/test_torch_lm_train.py holds a gossip round's; top-k's within 0.2,
  ``FLOAT32_MOVE_REL``), the losses within 5e-2; the bf16 block's moves
  (consensus's on the params, d, the estimates', the snapshots') within
  ``BF16_MOVE_REL`` of the reference's, by relative norm over the block,
  and from the reference's post-local state within ``SAME_STATE_REL``;
- the scan driver on token batches (a tuple and a dict of (C, T, K, B, S)
  tensors) and on a vlm's batch tree with float32 patches, for a task of one
  type and a mixed one in each mode, equal to C calls of the python driver
  bit for bit;
- a vlm round whose batches carry the image patches against the
  reference's, float32: the repaired task's batch tree.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.core import p2p as jp2p  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import p2p as tp2p  # noqa: E402
from repro_torch.core import task as task_lib  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
# one intra-op thread: the suite runs several workers on a few shared cores
torch.set_num_threads(1)

BF16_TOL = dict(atol=5e-2, rtol=5e-2)
MASS_TOL = dict(atol=5e-5, rtol=1e-4)
K, T, B, S = 4, 2, 2, 16
# a float32 leaf's move against the reference's, as in
# tests/test_torch_lm_train.py's gossip round (its readings on the CPU were
# at most 0.033); a leaf left unchanged or unmixed reads 0.9 to 1.1.  Top-k
# keeps a quarter of each leaf's coordinates, chosen by magnitude from the
# post-local leaf, which follows bf16 activations that the two frameworks
# round apart: a coordinate at the boundary that one keeps and the other
# does not moves by its whole difference (readings on the CPU: 0.062 for
# rwkv6's bonus, 0.097 for Mamba2's A_log), so top-k's float32 leaves are
# held to 0.2
FLOAT32_MOVE_REL = {"topk": 0.2}
FLOAT32_MOVE_REL_DEFAULT = 5e-2
# the bf16 block's moves against the reference's, by relative norm over the
# block's leaves together: one round moves a bf16 leaf of about 0.1 by about
# 1e-3, below the reach of BF16_TOL, so a round that skipped the block's
# consensus would pass that; readings on the CPU were at most 0.197 (rwkv6's
# consensus move on the qint8 wire), an unmixed round reads 1
BF16_MOVE_REL = 0.3
# the same, the port's consensus phase run from the reference's post-local
# state: push-sum's and staleness's moves and the snapshots read 0 on the
# CPU, top-k's move and the estimates at most 0.0055.  d (which the
# reference rounds to bf16 before it subtracts) and qint8's move (whose
# estimates differ by a few bf16 ulps, each about 4e-4 of a leaf of about
# 0.1) keep BF16_MOVE_REL: readings at most 0.14 and 0.19
SAME_STATE_REL = 1e-2
MODES = {
    "push_sum": dict(protocol="push_sum", topology="directed_ring"),
    "qint8": dict(compressor="qint8"),
    "topk": dict(compressor="topk", topk_frac=0.25),
    "staleness2": dict(staleness_bound=2, steps_profile="straggler"),
    "adaptive": dict(schedule="adaptive"),
}
ARCHS = ["smollm-135m", "rwkv6-7b", "zamba2-2.7b"]


def _config(**mode):
    return {**dict(algorithm="p2pl_affinity", num_peers=K, local_steps=T, consensus_steps=1,
                   lr=5e-2, momentum=0.5, eta_d=0.25, topology="complete"), **mode}


@functools.cache
def _reference_peer(arch):
    """One peer's initial leaves, max-norm synced as every P2PL init is (the
    reference's ``init_state`` draws K peers and every peer adopts the
    largest-norm draw of each leaf, so one peer's leaves are all of them)."""
    jmodel = jbuild_model(dataclasses.replace(jreduced(jget_config(arch)), dtype="bfloat16"))
    state = jp2p.init_state(jax.random.PRNGKey(3), jmodel.init, jp2p.P2PConfig(**_config()))
    return jax.tree.map(lambda leaf: leaf[0], state.params)


def _batches(vocab):
    tokens, labels = ttrain.lm_token_batches(np.random.default_rng(3), vocab, num_peers=K,
                                             local_steps=T, batch=B, seq=S)
    return tokens, labels


def _check_tree(what: str, got: dict, want_tree, start: dict | None,
                rel: float = FLOAT32_MOVE_REL_DEFAULT) -> None:
    """Every leaf of ``got`` in the reference's type; bf16 ones within
    BF16_TOL, float32 ones moved from ``start`` (zeros where None) as the
    reference's did, within ``rel`` of its move's norm."""
    want = interop.params_from_jax(jax.tree.map(np.asarray, want_tree))
    assert set(got) == set(want), what
    for name, g in got.items():
        w = want[name]
        assert g.dtype == w.dtype, f"{what} {name}"
        if g.dtype == torch.float32:
            base = (start[name] if start is not None else torch.zeros_like(g)).double()
            moved, want_moved = g.double() - base, w.double() - base
            if not bool(want_moved.any()):
                assert not bool(moved.any()), f"{what} {name}"
                continue
            err = float(torch.linalg.vector_norm(moved - want_moved)
                        / torch.linalg.vector_norm(want_moved))
            assert err <= rel, f"{what} {name}: moved {err:.3g} off"
        else:
            np.testing.assert_allclose(g.float().numpy(), w.float().numpy(), **BF16_TOL,
                                       err_msg=f"{what} {name}")


def _bf16_move_err(got: dict, got_from: dict | None, want: dict, want_from: dict | None) -> float:
    """How far the bf16 leaves of ``got`` moved from ``got_from`` otherwise
    than the reference's from ``want_from`` (zeros where None): the norm of
    the difference of the moves over the norm of the reference's, over all
    the bf16 leaves together, in float64."""
    num = den = 0.0
    for name, g in got.items():
        if g.dtype != torch.bfloat16:
            continue
        moved = g.double() - (0 if got_from is None else got_from[name].double())
        want_moved = want[name].double() - (0 if want_from is None else want_from[name].double())
        num += float(torch.linalg.vector_norm(moved - want_moved)) ** 2
        den += float(torch.linalg.vector_norm(want_moved)) ** 2
    assert den > 0
    return (num / den) ** 0.5


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("arch", ARCHS)
def test_round_matches_reference_in_every_mode(arch, mode):
    """One bf16 round in ``mode`` against the reference's ``make_round_fn``
    round: params and d after the local phase and after consensus, and the
    mode's own buffers; both blocks of a mixed task, each leaf in its type.
    The float32 block runs the float32 kernels' mode, the bf16 block the
    bf16 storage mode: one launch a block a step."""
    jcfg = jp2p.P2PConfig(**_config(**MODES[mode]))
    jmodel = jbuild_model(dataclasses.replace(jreduced(jget_config(arch)), dtype="bfloat16"))
    peer = _reference_peer(arch)
    jstate = jp2p.init_state(jax.random.PRNGKey(3), lambda _key: peer, jcfg)
    tokens, labels = _batches(jmodel.cfg.vocab_size)
    j_local, j_after, j_losses = jp2p.make_round_fn(jmodel.loss_fn, jcfg)(
        jstate, {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)})

    cfg = reduced(get_config(arch)).replace(dtype="bfloat16")
    task = task_lib.from_model(build_model(cfg))
    tcfg = tp2p.P2PConfig(**_config(**MODES[mode]))
    init = interop.params_from_jax(jax.tree.map(np.asarray, jstate.params))
    state = tp2p.init_state(task, tcfg, device="cpu", init_params=init)
    layout = tp2p.ParamLayout.of(task)
    assert (layout.wide is not None) == (arch != "smollm-135m")
    batches = {"tokens": torch.as_tensor(tokens, dtype=torch.int64),
               "labels": torch.as_tensor(labels, dtype=torch.int64)}
    t_local, t_after, t_losses = tp2p.make_round_fn(task, tcfg, device="cpu")(state, batches)
    np.testing.assert_allclose(t_losses.float().numpy(), np.asarray(j_losses, np.float32),
                               **BF16_TOL)
    views = lambda st, field: layout.views(*tp2p.blocks(st, field))  # noqa: E731
    jviews = lambda tree: interop.params_from_jax(jax.tree.map(np.asarray, tree))  # noqa: E731
    rel = FLOAT32_MOVE_REL.get(mode, FLOAT32_MOVE_REL_DEFAULT)
    for phase, jst, tst in (("local", j_local, t_local), ("consensus", j_after, t_after)):
        for field in ("params", "d_bias"):
            _check_tree(f"{mode} {phase} {field}", views(tst, field), getattr(jst, field),
                        init if field == "params" else None, rel)
    # the bf16 block's moves: consensus's on the params, the refreshed d, and
    # the mode's buffers from the initial leaves
    moves = {"consensus move": (views(t_after, "params"), views(t_local, "params"),
                                jviews(j_after.params), jviews(j_local.params)),
             "d": (views(t_after, "d_bias"), None, jviews(j_after.d_bias), None)}
    if mode in ("qint8", "topk"):
        moves["estimates"] = (views(t_after, "compression"), init,
                              jviews(j_after.compression), init)
    elif mode == "staleness2":
        moves["published"] = (views(t_after, "published"), init,
                              jviews(j_after.staleness.published), init)
    for what, args in moves.items():
        err = _bf16_move_err(*args)
        assert err <= BF16_MOVE_REL, f"{mode} bf16 {what}: moved {err:.3g} off"
    if mode != "adaptive":  # adaptive's operands are drawn inside the round
        # the port's consensus phase from the reference's post-local state:
        # the local phases' bf16 activations apart, the two agree closely
        j_start = jax.tree.map(np.asarray, j_local)
        t_cons = tp2p.consensus_phase(interop.state_from_jax(j_start, task), tcfg,
                                      tp2p.round_operands(tcfg, device="cpu")[0], layout=layout)
        same = {"consensus move": (views(t_cons, "params"), jviews(j_local.params),
                                   jviews(j_after.params), jviews(j_local.params)),
                "d": (views(t_cons, "d_bias"), None, jviews(j_after.d_bias), None)}
        if mode in ("qint8", "topk"):
            same["estimates"] = (views(t_cons, "compression"), jviews(j_local.compression),
                                 jviews(j_after.compression), jviews(j_local.compression))
        elif mode == "staleness2":
            same["published"] = (views(t_cons, "published"), init,
                                 jviews(j_after.staleness.published), init)
        for what, args in same.items():
            loose = what == "d" or (mode == "qint8" and what == "consensus move")
            limit = BF16_MOVE_REL if loose else SAME_STATE_REL
            err = _bf16_move_err(*args)
            assert err <= limit, f"{mode} bf16 {what} from the same state: moved {err:.3g} off"
    if mode == "push_sum":
        torch.testing.assert_close(t_after.protocol.mass,
                                   torch.as_tensor(np.asarray(j_after.protocol.mass)),
                                   **MASS_TOL)
    elif mode in ("qint8", "topk"):
        _check_tree(f"{mode} estimates", views(t_after, "compression"), j_after.compression,
                    init, rel)
    elif mode == "staleness2":
        _check_tree(f"{mode} published", views(t_after, "published"),
                    j_after.staleness.published, init)
        assert t_after.staleness.age.tolist() == np.asarray(j_after.staleness.age).tolist()
        # the straggler (the last peer) has not published: its snapshot is its init
        assert not bool(np.asarray(j_after.staleness.age)[-1] == 0)
    else:
        assert torch.equal(t_after.adaptive.key,
                           interop.key_from_jax(j_after.adaptive.key).expand(K, -1))
        np.testing.assert_allclose(t_after.adaptive.last_losses.numpy(),
                                   np.asarray(j_after.adaptive.last_losses), **BF16_TOL)


def _small_task(arch, dtype="bfloat16"):
    cfg = reduced(get_config(arch)).replace(dtype=dtype)
    if cfg.family == "rwkv6":
        cfg = cfg.replace(num_layers=1)
    return cfg, task_lib.from_model(build_model(cfg))


def _token_chunk(cfg, rounds, seed=0, *, as_dict=True):
    """C rounds of token batches, (C, T, K, B, S) int64 each."""
    rng = np.random.default_rng(seed)
    draws = [_batches_of(rng, cfg.vocab_size) for _ in range(rounds)]
    tokens = torch.stack([d[0] for d in draws])
    labels = torch.stack([d[1] for d in draws])
    return {"tokens": tokens, "labels": labels} if as_dict else (tokens, labels)


def _batches_of(rng, vocab):
    tokens, labels = ttrain.lm_token_batches(rng, vocab, num_peers=K, local_steps=T, batch=B,
                                             seq=S)
    return torch.as_tensor(tokens, dtype=torch.int64), torch.as_tensor(labels, dtype=torch.int64)


def _both_drivers(task, pcfg, chunk, rounds):
    """The python driver's ``rounds`` calls and one scan-driver call of the
    same chunk, from one initial state: (python final, scan final, python
    losses, scan losses, python after-local, scan after-local)."""
    state = tp2p.init_state(task, pcfg, seed=1, device="cpu")
    round_fn = tp2p.make_round_fn(task, pcfg, device="cpu")
    py, losses = state, []
    for c in range(rounds):
        local, py, step_losses = round_fn(py, tp2p.pytree.tree_map(lambda x: x[c], chunk))
        losses.append(step_losses)
    drive = tp2p.make_scan_driver(task, pcfg, device="cpu", donate=False)
    scan_local, scan, scan_losses = drive(state, chunk)
    return py, scan, torch.stack(losses), scan_losses, local, scan_local


@pytest.mark.parametrize("mode", ["gossip", *MODES])
@pytest.mark.parametrize("arch", ["smollm-135m", "rwkv6-7b"])
def test_scan_driver_on_token_batches_equals_python_driver(arch, mode):
    """The scan driver takes the reference's batch tree, (C, T, K, B, S)
    token and label tensors, and gives C python-driver rounds' bits: every
    carried leaf (both blocks of a mixed task, and each mode's own
    buffers), the after-local state and the losses; ``round_idx`` advances
    by C."""
    cfg, task = _small_task(arch)
    pcfg = tp2p.P2PConfig(**_config(**MODES.get(mode, {})))
    chunk = _token_chunk(cfg, 2, as_dict=mode != "topk")  # a tuple tree too
    py, scan, losses, scan_losses, local, scan_local = _both_drivers(task, pcfg, chunk, 2)
    assert scan.round_idx == py.round_idx == 2
    py_leaves, scan_leaves = tp2p.state_leaves(py), tp2p.state_leaves(scan)
    assert len(py_leaves) == len(scan_leaves)
    n_wide = len(tp2p._tensors(*py.wide)) if py.wide else 0
    assert n_wide == {"smollm-135m": 0}.get(arch, 4 + (mode in ("qint8", "topk", "staleness2")))
    for i, (a, b) in enumerate(zip(py_leaves, scan_leaves)):
        assert a.dtype == b.dtype and torch.equal(a, b), f"leaf {i}"
    for a, b in zip(tp2p.state_leaves(local), tp2p.state_leaves(scan_local)):
        assert torch.equal(a, b)
    assert torch.equal(losses, scan_losses)


def test_scan_driver_takes_a_vlm_batch_tree_of_mixed_types():
    """A vlm's batch tree, int64 tokens and labels beside float32 patches,
    through the scan driver: the python driver's bits, and the static
    buffers made anew (a new capture) when the tree's shapes change."""
    cfg = reduced(get_config("internvl2-2b"))
    task = task_lib.from_model(build_model(cfg))
    pcfg = tp2p.P2PConfig(**_config())
    gen = np.random.default_rng(5)
    chunk = _token_chunk(cfg, 2, seed=5)
    chunk["patches"] = torch.as_tensor(gen.normal(size=(2, T, K, B, cfg.num_prefix_embeddings,
                                                        cfg.frontend_dim)).astype(np.float32))
    py, scan, losses, scan_losses, _, _ = _both_drivers(task, pcfg, chunk, 2)
    for a, b in zip(tp2p.state_leaves(py), tp2p.state_leaves(scan)):
        assert torch.equal(a, b)
    assert torch.equal(losses, scan_losses)
    drive = tp2p.make_scan_driver(task, pcfg, device="cpu", donate=False)
    state = tp2p.init_state(task, pcfg, seed=1, device="cpu")
    drive(state, chunk)
    first = drive.captured
    drive(state, chunk)
    assert drive.captured is first  # the same form: the same capture
    drive(state, {name: leaf[:, :, :, :1] for name, leaf in chunk.items()})
    assert drive.captured is not first
    with pytest.raises(ValueError, match="C, T, K"):
        drive(state, {"tokens": chunk["tokens"], "labels": chunk["labels"][:1]})


def test_vlm_round_with_patches_matches_reference():
    """A vlm round whose batches carry the image patches (float32, beside
    int64 tokens) against the reference's ``make_round_fn`` round on the
    registry's batch dict, float32: the loss reads the patches (a text-only
    round differs), the losses and the parameters after the round allclose."""
    arch = "internvl2-2b"
    jmodel = jbuild_model(jreduced(jget_config(arch)))
    jcfg = jp2p.P2PConfig(**_config())
    jstate = jp2p.init_state(jax.random.PRNGKey(4), jmodel.init, jcfg)
    tokens, labels = _batches(jmodel.cfg.vocab_size)
    patches = np.random.default_rng(4).normal(
        size=(T, K, B, jmodel.cfg.num_prefix_embeddings, jmodel.cfg.frontend_dim)
    ).astype(np.float32)
    _, j_after, j_losses = jp2p.make_round_fn(jmodel.loss_fn, jcfg)(
        jstate, {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels),
                 "patches": jnp.asarray(patches)})
    cfg = reduced(get_config(arch))
    task = task_lib.from_model(build_model(cfg))
    tcfg = tp2p.P2PConfig(**_config())
    init = interop.params_from_jax(jax.tree.map(np.asarray, jstate.params))
    state = tp2p.init_state(task, tcfg, device="cpu", init_params=init)
    round_fn = tp2p.make_round_fn(task, tcfg, device="cpu")
    text = {"tokens": torch.as_tensor(tokens, dtype=torch.int64),
            "labels": torch.as_tensor(labels, dtype=torch.int64)}
    _, after, losses = round_fn(state, {**text, "patches": torch.as_tensor(patches)})
    np.testing.assert_allclose(losses.numpy(), np.asarray(j_losses), atol=5e-5, rtol=1e-4)
    want = interop.params_from_jax(jax.tree.map(np.asarray, j_after.params))
    for name, got in tp2p.param_views(after, task).items():
        np.testing.assert_allclose(got.numpy(), want[name].numpy(), atol=1e-4, rtol=1e-3,
                                   err_msg=name)
    _, _, text_losses = round_fn(state, text)
    assert not torch.allclose(text_losses, losses)


@pytest.mark.parametrize("arch", ["smollm-135m", "rwkv6-7b"])
def test_compressed_consensus_refuses_a_layout_not_the_states(arch):
    """A compressed wire quantizes leaf by leaf, so ``consensus_phase`` on an
    LM's state refuses the default layout (the 2NN's, ``layout_of(cfg.model)``)
    and a layout of another task, and takes the task's own."""
    _, task = _small_task(arch)
    cfg = tp2p.P2PConfig(**_config(compressor="qint8"))
    state = tp2p.init_state(task, cfg, seed=1, device="cpu")
    gen = torch.Generator().manual_seed(1)  # the peers apart from their estimates
    state = tp2p.with_blocks(state, params=[
        (p.float() + 1e-2 * torch.randn(p.shape, generator=gen)).to(p.dtype)
        for p in tp2p.param_blocks(state)])
    ops = tp2p.round_operands(cfg, device="cpu")[0]
    with pytest.raises(ValueError, match="layout"):
        tp2p.consensus_phase(state, cfg, ops)
    other = "rwkv6-7b" if arch == "smollm-135m" else "smollm-135m"
    with pytest.raises(ValueError, match="layout"):
        tp2p.consensus_phase(state, cfg, ops, layout=tp2p.ParamLayout.of(_small_task(other)[1]))
    after = tp2p.consensus_phase(state, cfg, ops, layout=tp2p.ParamLayout.of(task))
    assert after.round_idx == 1
    for block, before in zip(tp2p.blocks(after, "compression"), tp2p.blocks(state, "compression")):
        assert block.shape == before.shape and not torch.equal(block, before)
