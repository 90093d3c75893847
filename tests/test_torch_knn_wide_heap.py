"""The CUDA-core selection pass past k = 32 (`knn_exact_wide_kernel` in
`csrc/knn_filter.cuh`: kernels A and G at C <= 4, and kernel B's sinks
there), its design emulated on the CPU, and the tie-heavy cloud its card
check takes:

- `heap_pass` replays the kernel's steps in plain Python on the fold's
  distances (`ops.pairwise.self_sqdist`, which the kernel and the plain
  versions share): one bounded max-heap of k (key, column) entries a query,
  starting as k sentinels; a chunk walked in tiles of 64 keys from the
  tile of the block's first query; each tile's keys marked against the
  root as it stood at the tile's start, then each mark pushed if it still
  comes before the root; a heapsort at the end; several chunks' lists
  joined as the merge kernel joins them. It equals the plain versions
  (`knn_plain` in exact order, `knn_edge_plain`'s indices in packed order)
  at k = 33, 40, 63 and 64, with one chunk and with four;
- the tie-heavy cloud (`tie_cloud`, as `chip_smoke.py` draws it: a coarse
  integer grid with one point copied to every (N // 72)-th row) through
  `knn_plain` and `knn_blocked_plain` against the JAX package's Pallas
  kernels in interpret mode (as tests/test_pallas.py runs them): every
  distance there is a small integer, exact in any order of the sums, so
  indices are held exactly, ties to the lower index;
- on the card (marked `cuda`), kernels A and G on that cloud against the
  plain versions, bit for bit.
"""

import heapq

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from sp_gan_tpu.ops.pallas import knn as jknn
from sp_gan_tpu_torch.data.sphere import sphere_template
from sp_gan_tpu_torch.ops.kernels.knn import knn_plain
from sp_gan_tpu_torch.ops.kernels.knn_blocked import knn_blocked_plain
from sp_gan_tpu_torch.ops.kernels.knn_edge import knn_edge_plain
from sp_gan_tpu_torch.ops.pairwise import self_sqdist

torch.set_num_threads(2)   # six test workers share the host's cores

TIE_K = (33, 40, 63, 64)
QUERIES, TILE = 128, 64          # kSelQ and kT of csrc/knn_filter.cuh
INT_MAX = 2 ** 31 - 1
SENTINEL = (INT_MAX << 32) | INT_MAX
TIE_COPIES = 72


def tie_cloud(b: int, n: int, seed: int) -> np.ndarray:
    """[b, n, 3] float32: round(2 randn), each cloud's point 0 copied to
    every (n // TIE_COPIES)-th row."""
    x = np.round(2 * np.random.default_rng(seed).standard_normal((b, n, 3)))
    x[:, ::n // TIE_COPIES] = x[:, :1]
    return x.astype(np.float32)


CLOUDS = {
    "ties": lambda: tie_cloud(1, 256, 0),
    "randn": lambda: np.random.default_rng(1).standard_normal((1, 256, 3))
    .astype(np.float32),
    "template": lambda: sphere_template(256)[None],
}


def orderable(d: np.ndarray) -> np.ndarray:
    """The kernels' int32 image of f32 distances, ordered as the floats."""
    b = d.astype(np.float32).view(np.int32)
    return b ^ ((b >> 31) & 0x7fffffff)


def pack_key(d: np.ndarray, low: int, j: np.ndarray) -> np.ndarray:
    """The packed selection key: bits(max(d, 0)) with the column in its low
    bits."""
    dp = np.where(d < 0, np.float32(0), d).astype(np.float32)
    return (dp.view(np.int32) & ~np.int32(low)) | j.astype(np.int32)


def entry(key: int, col: int) -> int:
    """A heap entry as the kernel's signed 64-bit word: key high, column
    low; as a Python int, key * 2^32 + col keeps that order."""
    return (int(key) << 32) | int(col)


def sift(h: list, n: int, e: int) -> int:
    """heap_sift: `e` down from the free root of the max-heap h[:n]; the
    new root."""
    root, i, c = e, 0, 1
    while c < n:
        v = h[c]
        if c + 1 < n and h[c + 1] > v:
            v, c = h[c + 1], c + 1
        if not v > e:
            break
        h[i] = v
        if i == 0:
            root = v
        i, c = c, 2 * c + 1
    h[i] = e
    return root


def chunk_list(d: np.ndarray, qi: int, key0: int, key1: int, k: int,
               packed: bool, low: int, push=sift) -> list:
    """One query's heap over the keys [key0, key1) of distances d [N] (self
    at +inf), as knn_exact_wide_kernel builds it: k sorted entries.
    `push(h, k, e)` replaces the root and returns the new one."""
    h, root = [SENTINEL] * k, SENTINEL
    q0 = qi // QUERIES * QUERIES
    tiles = -(-(key1 - key0) // TILE)
    first = (q0 - key0) // TILE if key0 <= q0 < key1 else 0
    cols = np.arange(d.shape[0])
    keys = (pack_key(d, low, cols) if packed else orderable(d)).tolist()
    for it in range(tiles):
        ti = (first + it) % tiles
        t0 = key0 + ti * TILE
        t1 = min(key1, t0 + TILE)
        rk = root >> 32
        if packed:
            marks = [j for j in range(t0, t1) if keys[j] < rk]
        else:  # !(d > rd), rd the root's distance: NaN while short
            rd = np.int32(rk ^ ((rk >> 31) & 0x7fffffff)).view(np.float32)
            marks = [j for j in range(t0, t1) if not d[j] > rd]
        for j in marks:
            e = entry(keys[j], INT_MAX if packed else j)
            if e < root:
                root = push(h, k, e)
    for m in range(k - 1, 0, -1):    # heapsort, ascending
        top, e = h[0], h[m]
        h[m] = top
        sift(h, m, e)
    return h


def heap_pass(x: np.ndarray, k: int, chunks: int, packed: bool = False,
              push=sift):
    """The wide pass over `chunks` key chunks of 64-key multiples, then the
    merge (the k smallest of the chunks' S k entries, as knn_merge_kernel's
    list keeps them): per query its k entries' columns and keys."""
    B, N, _ = x.shape
    dist = self_sqdist(torch.from_numpy(x)).numpy()
    low = (1 << max((N - 1).bit_length(), 1)) - 1
    chunk = (-(-N // chunks) + TILE - 1) // TILE * TILE
    cols = np.empty((B, N, k), np.int64)
    keys = np.empty((B, N, k), np.int64)
    for b in range(B):
        for qi in range(N):
            parts = [e for key0 in range(0, N, chunk) for e in chunk_list(
                dist[b, qi], qi, key0, min(N, key0 + chunk), k, packed, low,
                push)]
            best = heapq.nsmallest(k, parts)
            keys[b, qi] = [e >> 32 for e in best]
            cols[b, qi] = [(e >> 32) & low if packed else e & 0xffffffff
                           for e in best]
    return cols, keys


@pytest.mark.parametrize("cloud", sorted(CLOUDS))
@pytest.mark.parametrize("k", TIE_K)
def test_heap_pass_equals_plain(k, cloud):
    """The emulated pass in exact order, with one key chunk and with four
    (the merge), against knn_plain: every index, and every distance bit
    for bit (the entries' keys are the distances' images)."""
    x = CLOUDS[cloud]()
    idx, dist = knn_plain(torch.from_numpy(x), k)
    want = orderable(dist.numpy())
    for chunks in (1, 4):
        cols, keys = heap_pass(x, k, chunks)
        np.testing.assert_array_equal(cols, idx.numpy())
        np.testing.assert_array_equal(keys, want)


@pytest.mark.parametrize("k", TIE_K)
def test_heap_pass_packed_equals_plain(k):
    """The emulated pass in packed order (kernel B's sinks at C <= 4) on
    the tie-heavy cloud, with one chunk and with four, against
    knn_edge_plain's packed indices."""
    x = CLOUDS["ties"]()
    _, idx = knn_edge_plain(torch.from_numpy(x), k, torch.float32, True,
                            "packed")
    for chunks in (1, 4):
        cols, _ = heap_pass(x, k, chunks, packed=True)
        np.testing.assert_array_equal(cols, idx.numpy())


def test_heap_pass_sees_a_wrong_root():
    """The control: a pass that takes the heap's smallest entry for its
    root marks and pushes too few keys, and the check above catches it."""
    x = CLOUDS["randn"]()

    def smallest_root(h, n, e):
        sift(h, n, e)
        return min(h[:n])
    cols, _ = heap_pass(x, 40, 1, push=smallest_root)
    idx, _ = knn_plain(torch.from_numpy(x), 40)
    assert (cols != idx.numpy()).any()


def _interpret(fn, *args):
    with pltpu.force_tpu_interpret_mode():
        return [np.asarray(o) for o in jax.jit(fn)(*args)]


def test_tie_cloud_plain_matches_pallas():
    """knn_plain and knn_blocked_plain at k = 33, 40, 63 and 64 on the
    tie-heavy cloud against knn_pallas and knn_pallas_blocked at k = 64
    (their first k columns): indices equal, distances equal (small
    integers, exact in every sum order)."""
    x = tie_cloud(1, 384, 2)
    pidx, pdist = _interpret(lambda v: jknn.knn_pallas(v, 64, tq=64),
                             jnp.asarray(x))
    bidx, bdist = _interpret(
        lambda v: jknn.knn_pallas_blocked(v, 64, tq=128, cb=128),
        jnp.asarray(x))
    for k in TIE_K:
        for plain in (knn_plain, knn_blocked_plain):
            idx, dist = plain(torch.from_numpy(x), k)
            for ridx, rdist in ((pidx, pdist), (bidx, bdist)):
                np.testing.assert_array_equal(idx.numpy(), ridx[..., :k])
                np.testing.assert_array_equal(dist.numpy(), rdist[..., :k])


@pytest.mark.cuda
class TestOnCard:
    @pytest.mark.parametrize("k", TIE_K)
    def test_wide_pass_on_ties(self, k):
        """Kernels A and G on the tie-heavy cloud at N = 2048 (B = 1: 32
        key chunks and the merge; B = 64: one chunk) against knn_plain, bit
        for bit, and bit-identical over two launches."""
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device (kernels have no CPU mode)")
        from sp_gan_tpu_torch.ops.kernels.knn import knn
        from sp_gan_tpu_torch.ops.kernels.knn_blocked import knn_blocked
        for b in (1, 64):
            x = torch.from_numpy(tie_cloud(b, 2048, k)).cuda()
            pidx, pdist = knn_plain(x, k)
            for fn in (knn, knn_blocked):
                idx, dist = fn(x, k)
                idx2, dist2 = fn(x, k)
                assert torch.equal(idx, idx2) and torch.equal(dist, dist2)
                assert torch.equal(idx, pidx) and torch.equal(dist, pdist)
