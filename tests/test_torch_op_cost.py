"""The op-level cost counter (``repro_torch.launch.op_cost``, the port's
counterpart of ``repro.launch.hlo_cost``) and the hand kernels' counts
(``launch.roofline.kernel_work``):

- a matmul and a batched einsum count the FLOPs that ``hlo_cost.analyze``
  counts for the jitted JAX equivalent, exactly;
- L layers in a loop count L times one layer (no trip counts needed);
- a backward counts twice the forward's matmul FLOPs;
- a copy's bytes are its input's and its output's; a view moves none; an
  in-place write into part of a tensor (the KV cache's) moves its values;
- the peak of live bytes follows allocations and frees;
- a kernel wrapper given fake tensors records its call by ``kernel_work``
  (nothing built or launched), and ``kernel_work`` at the main shapes of
  PERF.md section 6 gives that table's bounds, to the printed digits.

Everything runs on fake tensors (``FakeTensorMode``) or small CPU tensors;
the counts are exact integers.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro.launch import hlo_cost  # noqa: E402
from repro_torch.kernels import build, fake  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.mamba2 import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.rwkv6 import ops as wkv6_ops  # noqa: E402
from repro_torch.launch import mesh, op_cost, roofline  # noqa: E402

torch.set_num_threads(1)


def _hlo_flops(fn, *shapes) -> float:
    args = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    return hlo_cost.analyze(jax.jit(fn).lower(*args).compile().as_text()).flops


def _counted(fn, *shapes, dtype=torch.float32) -> op_cost.OpCost:
    with FakeTensorMode():
        args = [torch.empty(s, dtype=dtype, device="meta") for s in shapes]
        cost = op_cost.OpCost()
        with cost:
            fn(*args)
    return cost


def test_matmul_flops_equal_hlo_costs():
    cost = _counted(lambda a, b: a @ b, (64, 32), (32, 48))
    assert cost.flops == _hlo_flops(lambda a, b: a @ b, (64, 32), (32, 48)) == 2 * 64 * 48 * 32
    assert cost.flops_by == {"float32": 2 * 64 * 48 * 32}


def test_batched_einsum_flops_equal_hlo_costs():
    eq = "bij,bjk->bik"
    cost = _counted(lambda a, b: torch.einsum(eq, a, b), (4, 16, 24), (4, 24, 8))
    want = _hlo_flops(lambda a, b: jnp.einsum(eq, a, b), (4, 16, 24), (4, 24, 8))
    assert cost.flops == want == 2 * 4 * 16 * 8 * 24


def test_bf16_matmul_counts_at_the_bf16_rate():
    cost = _counted(lambda a, b: a @ b, (8, 16), (16, 4), dtype=torch.bfloat16)
    assert cost.flops_by == {"bf16": 2 * 8 * 4 * 16}
    card = mesh.Card.for_part()
    assert cost.compute_seconds(card) == 2 * 8 * 4 * 16 / card.bf16_flop_per_s


@pytest.mark.parametrize("layers", [1, 3, 7])
def test_layers_in_a_loop_count_layers_times_one(layers):
    def stack(x, w, n):
        for _ in range(n):
            x = torch.tanh(x @ w)
        return x

    one = _counted(lambda x, w: stack(x, w, 1), (32, 64), (64, 64))
    many = _counted(lambda x, w: stack(x, w, layers), (32, 64), (64, 64))
    assert many.flops == layers * one.flops
    assert many.op_bytes == layers * one.op_bytes


def test_backward_counts_twice_the_forward_matmuls():
    def fwd_bwd(x, w):
        w.requires_grad_(True)
        x.requires_grad_(True)
        torch.autograd.grad((x @ w).sum(), (x, w))

    fwd = _counted(lambda x, w: x @ w, (16, 32), (32, 8))
    both = _counted(fwd_bwd, (16, 32), (32, 8))
    assert both.flops == 3 * fwd.flops  # the forward, then dx and dw


def test_copy_bytes_and_views():
    n = 1000 * 4
    assert _counted(lambda x: x.clone(), (1000,)).op_bytes == 2 * n
    assert _counted(lambda x: x.to(torch.bfloat16), (1000,)).op_bytes == n + n // 2
    assert _counted(lambda x: x.view(10, 100).t()[2:], (1000,)).op_bytes == 0
    assert _counted(lambda x: torch.empty_like(x), (1000,)).op_bytes == 0
    assert _counted(lambda x: torch.ops.aten._unsafe_view(x, (10, 100)), (1000,)).op_bytes == 0


def test_a_partial_write_moves_its_values_not_its_target():
    def write(cache, rows):
        idx = torch.zeros(8, dtype=torch.int64, device=cache.device)
        cache.index_put_((idx,), rows)

    cost = _counted(write, (4096, 64), (8, 64))
    # the indices made and read, the rows read and written
    assert cost.op_bytes == 2 * 8 * 8 + 2 * 8 * 64 * 4


def test_peak_follows_allocations_and_frees():
    def run(x):
        a = x * 2  # 4000 B live
        b = a + 1  # 8000 B live
        del a
        c = b * 3  # 8000 B live (a freed)
        return c

    cost = _counted(run, (1000,))
    block = op_cost.BLOCK
    held = -(-4000 // block) * block
    assert cost.peak_bytes == 2 * held
    with FakeTensorMode():
        x = torch.empty(1000, device="meta")
        cost = op_cost.OpCost()
        with cost:
            assert cost.track(x) == 4000
            y = x * 2
            assert cost.live_bytes == 2 * held
            del y
            assert cost.live_bytes == held


def test_fake_kernel_calls_are_counted_by_their_work(monkeypatch):
    def no_build(*args, **kwargs):
        raise AssertionError("a fake call reached the kernel build")

    monkeypatch.setattr(build, "load_library", no_build)
    b, s, h, kh, d = 2, 256, 4, 2, 64
    with FakeTensorMode():
        q = torch.empty(b, s, h, d, dtype=torch.bfloat16, device="meta")
        k = torch.empty(b, s, kh, d, dtype=torch.bfloat16, device="meta")
        cost = op_cost.OpCost()
        with cost:
            out = flash_ops.gqa_flash_attention(q, k, k)
        assert fake.is_fake(out) and out.shape == q.shape and out.dtype == q.dtype
    assert cost.kernel_calls == {"flash_attention": 1}
    work = roofline.kernel_work("flash_attention", b=b, s=s, h=h, kh=kh, d=d, causal=True,
                                window=None, elem_bytes=2)
    assert cost.kernel_work == [("flash_attention", work)]
    assert cost.flops == work.flops  # the plain version's ops are not counted
    assert flash_ops.launches.count == 0


def test_real_cpu_tensors_never_take_the_fake_route(monkeypatch):
    def no_record(name, **shapes):
        raise AssertionError(f"a real tensor took the fake route of {name}")

    monkeypatch.setattr(fake, "record", no_record)
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(1, 16, 2, 8)).astype(np.float32))
    out = flash_ops.gqa_flash_attention(x, x, x)
    assert not fake.is_fake(out) and torch.isfinite(out).all()
    r = torch.as_tensor(rng.normal(size=(1, 8, 2, 16)).astype(np.float32))
    ld = -torch.rand(1, 8, 2, 16)
    u = torch.zeros(2, 16)
    assert torch.isfinite(wkv6_ops.wkv6(r, r, r, ld, u, chunk=4)[0]).all()
    xs = torch.as_tensor(rng.normal(size=(1, 8, 2, 16)).astype(np.float32))
    bm = torch.as_tensor(rng.normal(size=(1, 8, 1, 8)).astype(np.float32))
    dt = torch.rand(1, 8, 2)
    a = -torch.rand(2)
    assert torch.isfinite(ssd_ops.ssd(xs, bm, bm, dt, a, chunk=4)[0]).all()


# PERF.md section 6's bounds at the main shapes (ms, as printed), on the
# NVIDIA H100 80GB HBM3 peaks
PERF_TABLE_BOUNDS = [
    ("consensus_mix", dict(k=100, n=199212, d=99), "0.11863520597014925"),
    ("dequant_mix", dict(k=100, n=199212, d=99, leaves=6), "0.12491546268656717"),
    ("segment_mix", dict(k=4096, n=199212, d=2), "2.922920272238806"),
    ("wkv6", dict(b=4, t=1024, h=64, dk=64, q=16, state=False, in_bytes=2, out_bytes=2),
     "0.08225843964179104"),
    ("ssd", dict(b=4, t=1024, h=80, g=1, p=64, n=64, q=64, state=False, in_bytes=2),
     "0.03983033313432836"),
    ("flash_attention", dict(b=4, s=1024, h=32, kh=8, d=128, causal=True, window=None,
                             elem_bytes=2), "0.0347758268958544"),
    ("flash_attention_bwd", dict(b=16, s=1024, h=9, kh=3, d=64, causal=True, window=None,
                                 elem_bytes=2), "0.0489"),
    ("wkv6_bwd", dict(b=4, t=1024, h=64, dk=64, in_bytes=2, u_rows=2, state=True,
                      dstate=False), "0.11270235701492537"),
    ("ssd_bwd", dict(b=2, t=1024, h=80, g=1, p=64, n=64, in_bytes=2, a_rows=2, state=True,
                     dstate=False), "0.027310309253731346"),
]


@pytest.mark.parametrize("name,shapes,printed", PERF_TABLE_BOUNDS,
                         ids=[c[0] for c in PERF_TABLE_BOUNDS])
def test_kernel_work_gives_the_kernel_tables_bounds(name, shapes, printed):
    card = mesh.Card("NVIDIA H100 80GB HBM3, 700.00 W")
    bound = card.work_bound(roofline.kernel_work(name, **shapes))["bound_ms"]
    digits = len(printed.split(".")[1])
    assert f"{bound:.{digits}f}" == f"{float(printed):.{digits}f}"


def test_kernel_work_refuses_an_unknown_kernel():
    with pytest.raises(ValueError, match="unknown kernel"):
        roofline.kernel_work("matmul", b=1)
