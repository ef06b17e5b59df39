"""The host side of the dilated-conv kernel K5 (consistencytta_torch/ops/
dilated_conv.py), on the CPU: the weight pack the kernel reads, kept in a
caller's `ops._packs.Pack`, the tile plan that sizes the kernel's shared
memory, the refusals that come before any launch, and the kernel's
shared-memory layouts (the wgmma
operands through their descriptors, the staged output tile) composed in
numpy into the conv itself.

The layout test mirrors csrc/dilated_conv.cu: a tap's weights are an
unswizzled K-major wgmma A operand [C/8][MP][8] (leading offset MP * 16
bytes, stride offset 128), the window a B operand [C/8][WB][8] (leading
offset WB * 16) whose start moves by 16 bytes a position, and y leaves
through 128-byte-swizzled boxes of C x 64 positions. Inputs come from a
numpy seed; the sums are float32 over at most 704 bf16 products, held to
1e-4 of the output's largest magnitude.
"""

import numpy as np
import pytest
import torch

from consistencytta_torch.ops import _build
from consistencytta_torch.ops import dilated_conv as dc
from consistencytta_torch.ops._packs import Pack


def _unpack(packed: torch.Tensor, c: int) -> torch.Tensor:
    """The inverse of `pack_weights`: [C_out, C_in, k]."""
    k = packed.shape[0]
    return packed[:, :, :c].transpose(2, 3).reshape(k, c, c).permute(2, 1, 0)


@pytest.mark.parametrize("k", [3, 7, 11])
@pytest.mark.parametrize("c", [32, 64, 128])
def test_weight_pack_round_trips(c, k):
    """[k, C/8, max(C, 64), 8] bf16, [t, g, co, e] = w[co, 8 g + e, t], zero
    rows up to 64 at C = 32; unpacked, every weight comes back exactly."""
    w = torch.from_numpy(np.random.default_rng(c + k).standard_normal((c, c, k),
                                                                      dtype=np.float32))
    packed = dc.pack_weights(w)
    assert packed.shape == (k, c // 8, max(c, 64), 8) and packed.dtype == torch.bfloat16
    assert packed.is_contiguous()
    assert torch.equal(_unpack(packed, c), w.bfloat16())
    assert torch.equal(packed[k - 1, 2, 5, 3], w[5, 19, k - 1].bfloat16())
    assert not packed[:, :, c:].any()


def test_pack_cache_repacks_after_in_place_update():
    """The pack in the caller's `Pack`."""
    w = torch.randn(64, 64, 3, generator=torch.Generator().manual_seed(0)).bfloat16()
    pack = Pack()

    def get(w):
        return pack.get((w,), lambda: dc.pack_weights(w))

    first = get(w)
    assert get(w) is first  # same version: the same pack
    with torch.no_grad():
        w.mul_(2.0)  # an optimizer step updates in place
    second = get(w)
    assert second.data_ptr() == first.data_ptr()  # made anew into the same storage
    assert torch.equal(_unpack(second, 64), w)
    assert get(w.clone()).data_ptr() != second.data_ptr()  # new tensors are packed anew


@pytest.mark.parametrize("tma", [True, False])
@pytest.mark.parametrize("c", [32, 64, 128])
def test_plan_fits_the_shared_memory(c, tma):
    """Every plan it gives fits the 227-KB block (232448 bytes), holds the
    window of a tile (N + (k-1)d positions and the 8-alignment of its start)
    in each consumer's buffer and TMA stage, and keeps within the kernel's
    rings; where it gives none, not even one consumer, one weight slot and
    no TMA ring fit."""
    accepted = 0
    for k in (1, 2, 3, 5, 7, 11, 15, 31):
        for d in (1, 2, 3, 5, 8, 33, 100, 250, 700, 1600, 3400):
            plan = dc.tile_plan(c, k, d, tma)
            need = dc.tile_positions(c) + (k - 1) * d + 7
            if plan is None:
                wb = -(-need // 32) * 32
                assert dc.smem_bytes(c, wb, 0, 0, 1, 1) > dc.SMEM_LIMIT
                continue
            accepted += 1
            assert plan.smem == dc.smem_bytes(c, plan.wb, plan.wr, plan.xs, plan.ws, plan.ncw)
            assert plan.smem <= dc.SMEM_LIMIT == 232448
            assert plan.wb % 32 == 0 and plan.wb >= need
            assert 0 <= plan.xs <= 2 and (plan.xs > 0) <= tma
            assert plan.wr == 0 if plan.xs == 0 else (plan.wr % 64 == 0 and plan.wr >= plan.wb)
            # resident, a ring of 3 slots, or (the last rung) one slot
            assert plan.ws in (k, 3) or (plan.ws, plan.ncw, plan.xs) == (1, 1, 0)
            assert plan.ncw in (1, 2)
    assert accepted > 40


def test_plan_at_the_vocoder_shapes():
    """C = 64, the six (k, d) pairs at L % 8 == 0: every tap resident, two
    consumers, a TMA ring; C = 128 at k = 11: the taps streamed."""
    for k, d in ((3, 3), (3, 5), (7, 3), (7, 5), (11, 3), (11, 5)):
        plan = dc.tile_plan(64, k, d)
        assert plan.ws == k and plan.ncw == 2 and plan.xs >= 1
    assert dc.tile_plan(128, 11, 5).ws == 3
    assert dc.tile_plan(32, 11, 5).ws == 11


@pytest.mark.parametrize("c", [32, 64, 128])
def test_plan_takes_every_conv_the_first_kernel_took(c):
    """No coverage lost: every (k, d) that the kernel before the plan took
    ((2 min(C, 64) + N + (k-1)d) rows of C + 8 bf16 values in 232448 bytes,
    N = 512, 256, 128 positions at C = 32, 64, 128) gets a plan, with or
    without TMA; only at C = 128 do the widest of them need the single tap
    slot."""
    n = {32: 512, 64: 256, 128: 128}[c]
    one_slot = 0
    for k in (2, 3, 5, 7, 11, 31):
        for d in range(1, 2400):
            if (2 * min(c, 64) + n + (k - 1) * d) * (c + 8) * 2 > dc.SMEM_LIMIT:
                break
            for tma in (True, False):
                plan = dc.tile_plan(c, k, d, tma)
                assert plan is not None, (k, d, tma)
                one_slot += plan.ws == 1 < k
    assert (one_slot > 0) == (c == 128)


def _cpu_args(c, length, k, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(1)
    return (torch.randn(1, c, length, generator=g).to(dtype),
            torch.randn(c, c, k, generator=g).to(dtype))


def test_wrapper_refuses_before_any_launch(monkeypatch):
    """What the kernel does not take raises in the wrapper, before the library
    is loaded (here, where no kernel can be built, loading it would fail)."""
    def no_load(name):
        raise AssertionError(f"{name} loaded")

    monkeypatch.setattr(_build, "load", no_load)
    before = dc.dilated_conv1d.launches
    x, w = _cpu_args(64, 100, 3)
    with pytest.raises(ValueError, match="shared memory"):
        dc._dilated_conv_cuda(x, w, 1000, 1000)  # a window of 2135 positions
    with pytest.raises(ValueError, match="32, 64 or 128"):
        dc._dilated_conv_cuda(*_cpu_args(48, 100, 3), 1, 1)
    with pytest.raises(TypeError):
        dc._dilated_conv_cuda(*_cpu_args(64, 100, 3, torch.float32), 1, 1)
    with pytest.raises(ValueError, match="non-empty"):
        dc._dilated_conv_cuda(x, w, 60, 0)
    with pytest.raises(ValueError, match="out must be"):
        dc._dilated_conv_cuda(x, w, 1, 1, out=torch.empty(1, 64, 99, dtype=torch.bfloat16))
    assert dc.dilated_conv1d.launches == before


def _operand(mem, start16, lbo, sbo, rows):
    """rows x 16 values of an unswizzled K-major wgmma operand: element (r,
    kk) at 16-byte unit start + r % 8 + (r // 8) * sbo/16 + (kk // 8) * lbo/16,
    value kk % 8 of it."""
    r, kk = np.arange(rows)[:, None], np.arange(16)[None, :]
    unit = start16 + r % 8 + (r // 8) * (sbo // 16) + (kk // 8) * (lbo // 16)
    return mem[unit * 8 + kk % 8]


def _staged(c, co, n):
    """Element (co, n) of a y tile in 128-byte-swizzled boxes of C x 64."""
    return (n >> 6) * c * 64 + co * 64 + ((((n >> 3) & 7) ^ (co & 7)) << 3) + (n & 7)


@pytest.mark.parametrize("c,length,k,d,p", [(32, 150, 3, 5, 5), (64, 200, 11, 5, 25),
                                            (128, 130, 3, 3, 3), (64, 21, 7, 3, 0)])
def test_layouts_compose_to_the_conv(c, length, k, d, p):
    rng = np.random.default_rng(k * d + c)
    x = rng.standard_normal((2, c, length)).astype(np.float32)
    w = torch.from_numpy(rng.standard_normal((c, c, k)).astype(np.float32)).bfloat16()
    l_out = length + 2 * p - d * (k - 1)
    n_tile, mp = dc.tile_positions(c), dc.weight_rows(c)
    plan = dc.tile_plan(c, k, d)
    wb, off = plan.wb, (-p) % 8
    packed = dc.pack_weights(w).float().numpy().reshape(-1)
    y = np.full((2, c, l_out), np.nan, np.float32)
    co, n = np.arange(c)[:, None], np.arange(n_tile)[None, :]
    for b in range(2):
        for t0 in range(0, l_out, n_tile):
            # the window from t0 - p - off, zero outside the signal, as [C/8][WB][8]
            pos = t0 - p - off + np.arange(wb)
            inside = (pos >= 0) & (pos < length)
            win = np.where(inside, x[b][:, np.clip(pos, 0, length - 1)], 0.0)
            buf = win.reshape(c // 8, 8, wb).transpose(0, 2, 1).reshape(-1)
            acc = np.zeros((mp, n_tile), np.float32)
            for t in range(k):
                for ks in range(c // 16):
                    bop = _operand(buf, off + t * d + 2 * ks * wb, wb * 16, 128, n_tile)
                    for mt in range(mp // 64):
                        aop = _operand(packed, t * c * mp // 8 + 2 * ks * mp + 64 * mt,
                                       mp * 16, 128, 64)
                        acc[64 * mt:64 * mt + 64] += aop @ bop.T
            staged = np.zeros(c * n_tile, np.float32)
            staged[_staged(c, co, n)] = acc[:c]
            keep = min(n_tile, l_out - t0)
            y[b, :, t0:t0 + keep] = staged[_staged(c, co, n)][:, :keep]
    want = dc.dilated_conv1d_plain(torch.from_numpy(x), w.float(), d, p).numpy()
    assert np.abs(y - want).max() <= 1e-4 * np.abs(want).max()
