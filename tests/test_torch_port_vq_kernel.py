"""The fused VQ kernel's index arithmetic (`csrc/vq_fused.cu`), emulated in
numpy on the CPU and held to the JAX package's Pallas kernel (interpret
mode, as the JAX package's own tests run it).

The emulation follows the source's maps: the persistent walk over tiles,
the staging map into shared memory that starts as NaN (so a read of an
unstaged slot shows), the per-row scores in channel order, the cooperative
quantized-row stores, the (group, channel) ownership and row order of the
statistics, the row lists of the generic instance, and the fixed-order
reduce across blocks. The kernel itself runs only on a CUDA card
(`test_torch_port_gpu.py`).
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from medical_image_editing_tpu.ops import vq_pallas as jvqp

_CU = (Path(__file__).resolve().parent.parent / "medical_image_editing_tpu_torch"
       / "csrc" / "vq_fused.cu")
INT_MAX = 2**31 - 1


def _cu_constants():
    return {name: int(v) for name, v in
            re.findall(r"constexpr int (k\w+) = (\d+);", _CU.read_text())}


def _row_stride(c):
    return 4 * (((c + 3) // 4) | 1)


def _fma(a, b, acc):
    """f32 fused multiply-add: the product exact in f64, one rounding."""
    f64 = lambda v: np.asarray(v, np.float64)  # noqa: E731
    return (f64(a) * f64(b) + f64(acc)).astype(np.float32)


def _esq(e_s, stride, k, c):
    s = np.zeros(k, np.float32)
    rows = np.arange(k) * stride
    for cc in range(c):
        s = _fma(e_s[rows + cc], e_s[rows + cc], s)
    return s


def _emulate_fixed(x, e, grid):
    """<16, 10>: returns (ids, quant, partials)."""
    kc = _cu_constants()
    threads, rows_t = kc["kThreads"], kc["kRows"]
    n, c = x.shape
    k = e.shape[0]
    q_n, s_n = c // 4, _row_stride(c)
    groups, gstride, slots = threads // c, k * c + 16, k + k * c
    xf, ef = x.ravel(), e.ravel()
    ids = np.full(n, -1, np.int64)
    quant = np.full(n * c, np.nan, np.float32)
    partials = np.full(grid * slots, np.nan, np.float32)
    ntiles = -(-n // rows_t)
    tid = np.arange(threads)
    lane, warp = tid & 31, tid >> 5
    for b in range(grid):
        x_s = np.full((2, rows_t * s_n), np.nan, np.float32)
        e_s = ef.copy()
        esq = _esq(e_s, c, k, c)
        sums_s = np.zeros(groups * gstride, np.float32)
        counts_s = np.zeros(groups * k, np.float32)

        def stage(tile, buf):
            row0 = tile * rows_t
            rows = min(rows_t, n - row0)
            for j in range(q_n):
                i = tid + threads * j
                r, q = i // q_n, i % q_n
                ok = r < rows
                for w in range(4):
                    x_s[buf, (r * s_n + 4 * q + w)[ok]] = xf[((row0 + r) * c + 4 * q + w)[ok]]

        stage(b, 0)
        for it, tile in enumerate(range(b, ntiles, grid)):
            buf = it & 1
            if tile + grid < ntiles:
                stage(tile + grid, buf ^ 1)
            row0 = tile * rows_t
            rows = min(rows_t, n - row0)
            xt = x_s[buf]
            # 1. scores: thread t < rows holds row t (kQ 16-byte loads)
            t = tid[:rows]
            xr = np.stack([xt[t * s_n + 4 * q + w] for q in range(q_n) for w in range(4)], 1)
            best = np.full(rows, -np.inf, np.float32)
            best_k = np.zeros(threads, np.int64)
            for kk in range(k):
                acc = np.zeros(rows, np.float32)
                for q in range(q_n):
                    for w in range(4):
                        acc = _fma(xr[:, 4 * q + w], e_s[kk * c + 4 * q + w], acc)
                s = np.float32(2) * acc - esq[kk]
                upd = s > best
                best = np.where(upd, s, best)
                best_k[:rows] = np.where(upd, kk, best_k[:rows])
            ids[row0 + t] = best_k[:rows]
            ids_s = best_k.copy()
            # 2. quantized rows: chunk m of warp w's rows, id shuffled from lane m / kQ
            for j in range(q_n):
                m = 32 * j + lane
                r, q = 32 * warp + m // q_n, m % q_n
                idl = best_k[32 * warp + m // q_n]
                ok = r < rows
                for w in range(4):
                    quant[((row0 + r) * c + 4 * q + w)[ok]] = e_s[(idl * c + 4 * q + w)[ok]]
            # 3. statistics: thread (g, gc) adds rows g, g + groups, ... in order
            gc, gg = tid % c, tid // c
            for i in range(-(-rows_t // groups)):
                r = gg + groups * i
                ok = r < rows
                idr = ids_s[r[ok]]
                dst = gg[ok] * gstride + idr * c + gc[ok]
                sums_s[dst] = sums_s[dst] + xt[r[ok] * s_n + gc[ok]]
                cnt = ok & (gc == 0)
                dst = gg[cnt] * k + ids_s[r[cnt]]
                counts_s[dst] = counts_s[dst] + np.float32(1)
        s = np.arange(slots)
        tot = np.zeros(slots, np.float32)
        for g in range(groups):
            tot = tot + np.where(s < k, counts_s[g * k + np.minimum(s, k - 1)],
                                 sums_s[g * gstride + np.maximum(s - k, 0)])
        partials[b * slots + s] = tot
    return ids, quant, partials


def _emulate_generic(x, e, grid):
    """<0, 0>: returns (ids, quant, partials)."""
    kc = _cu_constants()
    threads, rows_t = kc["kThreads"], kc["kGenericRows"]
    slices, chains = kc["kSlices"], kc["kChains"]
    n, c = x.shape
    k = e.shape[0]
    q_n, s_n, slots = (c + 3) // 4, _row_stride(c), k + k * c
    xf = x.ravel()
    ids = np.full(n, -1, np.int64)
    quant = np.full(n * c, np.nan, np.float32)
    partials = np.full(grid * slots, np.nan, np.float32)
    ntiles = -(-n // rows_t)
    tid = np.arange(threads)
    lane, warp = tid & 31, tid >> 5
    rl, sl = lane & 3, lane >> 2
    r_own = 4 * warp + rl
    cols = np.arange(4 * q_n)
    e_s = np.full(k * s_n, np.nan, np.float32)
    for r in range(k):
        e_s[r * s_n + cols] = np.where(cols < c, e.ravel()[r * c + np.minimum(cols, c - 1)], 0)
    esq = _esq(e_s, s_n, k, c)
    for b in range(grid):
        pb = np.zeros(slots, np.float32)
        x_s = np.full(rows_t * s_n, np.nan, np.float32)
        ids_s = np.full(rows_t, -1, np.int64)
        for tile in range(b, ntiles, grid):
            row0 = tile * rows_t
            rows = min(rows_t, n - row0)
            for r in range(rows):
                if c % 4 == 0:  # 16-byte copies, lanes along the chunks
                    for q in range(q_n):
                        x_s[r * s_n + 4 * q + np.arange(4)] = xf[(row0 + r) * c + 4 * q
                                                                 + np.arange(4)]
                else:
                    x_s[r * s_n + cols] = np.where(
                        cols < c, xf[(row0 + r) * c + np.minimum(cols, c - 1)], 0)
            # 1. scores of row r_own against codes sl + slices*m + 32i
            best = np.full(threads, -np.inf, np.float32)
            best_k = np.full(threads, INT_MAX, np.int64)
            for kb in range(0, k, chains * slices):
                kcs = [kb + sl + slices * m for m in range(chains)]
                er = [np.minimum(kk, k - 1) * s_n for kk in kcs]
                acc = np.zeros((chains, threads), np.float32)
                for q in range(q_n):
                    for w in range(4):
                        xv = x_s[r_own * s_n + 4 * q + w]
                        for m in range(chains):
                            acc[m] = _fma(xv, e_s[er[m] + 4 * q + w], acc[m])
                for m in range(chains):
                    s = np.float32(2) * acc[m] - esq[np.minimum(kcs[m], k - 1)]
                    upd = (kcs[m] < k) & (s > best)
                    best = np.where(upd, s, best)
                    best_k = np.where(upd, kcs[m], best_k)
            for off in (4, 8, 16):  # shuffles read the old values
                ob, ok = best[tid ^ off], best_k[tid ^ off]
                take = (ob > best) | ((ob == best) & (ok < best_k))
                best, best_k = np.where(take, ob, best), np.where(take, ok, best_k)
            best_k = np.where(best_k == INT_MAX, 0, best_k)
            lead0 = sl == 0
            ids_s[r_own[lead0]] = best_k[lead0]
            mine = lead0 & (r_own < rows)
            ids[row0 + r_own[mine]] = best_k[mine]
            # 2. quantized rows, a warp a row
            for r in range(rows):
                quant[(row0 + r) * c + np.arange(c)] = e_s[ids_s[r] * s_n + np.arange(c)]
            # 3. row lists: lanes with the same id, led by the lowest
            idl = np.where(np.arange(32) < rows, ids_s, -1)
            same = [sum(1 << j for j in range(32) if idl[j] == idl[i]) for i in range(32)]
            lists = [m if idl[i] >= 0 and (m & -m) == 1 << i else 0
                     for i, m in enumerate(same)]
            for i, m in enumerate(lists):
                if m:
                    pb[idl[i]] = pb[idl[i]] + np.float32(bin(m).count("1"))
            # 4. sums: each list's rows in row order, then into the partial
            cc = np.arange(c)
            for i, m in enumerate(lists):
                if not m:
                    continue
                v = np.zeros(c, np.float32)
                for rr in (j for j in range(32) if m >> j & 1):
                    v = v + x_s[rr * s_n + cc]
                dst = k + ids_s[i] * c + cc
                pb[dst] = pb[dst] + v
        partials[b * slots:(b + 1) * slots] = pb
    return ids, quant, partials


def _emulate_reduce(partials, grid, slots):
    """vq_reduce_kernel: warp sy sums blocks sy, sy + 32, ...; then the warps
    in order."""
    stats = np.full(slots, np.nan, np.float32)
    for blk in range(-(-slots // 32)):
        s = blk * 32 + np.arange(32)
        ok = s < slots
        red = np.zeros((32, 32), np.float32)
        for sy in range(32):
            acc = np.zeros(32, np.float32)
            for b in range(sy, grid, 32):
                acc = acc + np.where(ok, partials[b * slots + np.minimum(s, slots - 1)], 0)
            red[sy] = acc
        t = red[0]
        for sy in range(1, 32):
            t = t + red[sy]
        stats[s[ok]] = t[ok]
    return stats


def emulate(x, e, grid):
    """The kernel's (ids, quantized, counts, sums) for x (N, C), e (K, C)
    on a persistent grid of `grid` blocks."""
    n, c = x.shape
    k = e.shape[0]
    fixed = (c, k) == (16, 10)
    ids, quant, partials = (_emulate_fixed if fixed else _emulate_generic)(x, e, grid)
    stats = _emulate_reduce(partials, grid, k + k * c)
    return ids, quant.reshape(n, c), stats[:k], stats[k:].reshape(k, c)


@pytest.mark.parametrize("n,c,k,grid", [
    (1, 16, 10, 1),        # N below one tile
    (255, 16, 10, 1),      # tile - 1
    (257, 16, 10, 2),      # tile + 1
    (1000, 16, 10, 3),     # ragged, blocks walking two tiles (both stages)
    (4096, 16, 10, 3),     # sixteen tiles on three blocks
    (31, 96, 12, 1),       # generic: tile - 1
    (33, 16, 17, 2),       # generic: tile + 1, C 16 with K past 10
    (1000, 3, 5, 3),       # generic: C not a multiple of 4 (plain copies)
    (100, 16, 1, 2),       # generic: K = 1
    (600, 20, 40, 4),      # generic: K past one round of 32 codes
], ids=lambda v: str(v))
def test_vq_kernel_index_arithmetic_matches_pallas(n, c, k, grid):
    rng = np.random.default_rng(n + c + k)
    x = rng.normal(size=(n, c)).astype(np.float32)
    e = rng.normal(size=(k, c)).astype(np.float32)
    ids, quant, counts, sums = emulate(x, e, grid)
    assert np.isfinite(quant).all() and np.isfinite(counts).all() and np.isfinite(sums).all()
    with jax.default_matmul_precision("highest"):
        want = [np.asarray(a) for a in jvqp.vq_assign_fused(jnp.asarray(e), jnp.asarray(x))]
    np.testing.assert_array_equal(ids, want[0])
    np.testing.assert_array_equal(quant, want[1])
    np.testing.assert_array_equal(counts, want[2])
    np.testing.assert_allclose(sums, want[3], rtol=1e-5, atol=1e-5)


def test_row_stride_spreads_eight_rows_over_the_banks():
    """Eight consecutive rows read at one 16-byte offset fall in eight
    different groups of four banks, for every C the kernel takes."""
    for c in range(1, 1100):
        s = _row_stride(c)
        assert s % 4 == 0 and s >= c
        groups = {(r * s // 4) % 8 for r in range(8)}
        assert len(groups) == 8, c
