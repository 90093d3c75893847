"""Kernel C's f32 mode (`ops/kernels/edgeblock.py::edge_tail` on an f32 ee)
on the tensor cores: every product of the chain and the contraction with
wout as three TF32 products, x = hi + lo with hi = tf32(x) and
lo = tf32(x - hi), a b = ah bh + ah bl + al bh (`csrc/edgeblock_tf32.cu`).

The card holds the kernel to the f32 gate of `chip_smoke.py`'s
`check_edge_tail`: |err| <= 1e-5 + 1e-4 |plain| against `edge_tail_plain`
with TF32 off. The CPU tests guard the premise of that design where there
is no card: with tf32 rounding emulated in torch (to nearest, ties away,
10 stored mantissa bits, as `cvt.rna.tf32.f32`), the tail computed with
three TF32 products a matmul holds the gate at EdgeConv2's widths on
normal, offset and scaled inputs, and with one TF32 product it does not,
so the gate tells the two apart.
"""

import numpy as np
import pytest
import torch

from sp_gan_tpu_torch.ops.kernels.edgeblock import edge_tail, edge_tail_plain

torch.set_num_threads(2)   # six test workers share the host's cores

GATE_ABS, GATE_REL = 1e-5, 1e-4

# (C, F2, F, k, B, N): EdgeConv2's and EdgeConv1's widths at a small N,
# k = 7, 20 and 32 (k bounded by 32), and a point count that leaves the
# tile pass a ragged last tile (8 points a tile at k = 10)
CASES = {
    "EdgeConv2": (64, 64, 128, 10, 2, 256),
    "EdgeConv1": (3, 32, 64, 10, 2, 256),
    "k 7": (64, 64, 128, 7, 2, 128),
    "k 20": (64, 64, 128, 20, 2, 128),
    "k 32": (64, 64, 128, 32, 1, 64),
    "ragged last tile": (64, 64, 128, 10, 2, 125),
    "EdgeConv1, k 20": (3, 32, 64, 20, 2, 125),
}
# inputs as drawn, offset by +10, scaled by 10 (where the relative part of
# the gate binds)
INPUTS = {"normal": (0.0, 1.0), "offset +10": (10.0, 1.0),
          "scaled x10": (0.0, 10.0)}


def tail_args(C, F2, F, k, B, N, offset=0.0, scale=1.0, seed=1):
    """Kernel C's f32 arguments (ee, w1, a1, w2, a2, wx, ax, wout, bout),
    drawn with numpy from `seed`: weights at about unit output scale,
    affines [1 + 0.1 r; 0.1 r], ee = r * scale + offset."""
    rng = np.random.default_rng(seed)

    def r(*s):
        return rng.standard_normal(s).astype(np.float32)

    def aff(n):
        return np.stack([1 + 0.1 * r(n), 0.1 * r(n)])

    arrays = (r(B, N, k, 2 * C) * scale + offset, r(C, F2) / np.sqrt(C),
              aff(F2), r(F2, F) / 8, aff(F), r(2 * C, F) / np.sqrt(2 * C),
              aff(F), r(k, F, F) / 36, r(1, F))
    return tuple(torch.from_numpy(np.ascontiguousarray(a, np.float32))
                 for a in arrays)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to tf32 (10 stored mantissa bits), to nearest with ties
    away from zero, as cvt.rna.tf32.f32; x f32."""
    bits = x.contiguous().view(torch.int32)
    return torch.bitwise_and(bits + 0x1000, -0x2000).view(torch.float32)


def mm_tf32(a: torch.Tensor, b: torch.Tensor, products: int):
    """a @ b from tf32 operands: products = 3 sums ah bh + ah bl + al bh
    (hi = tf32(x), lo = tf32(x - hi)), products = 1 takes ah bh alone;
    the products are exact (float64) and the sum is rounded to f32."""
    ah, bh = tf32(a), tf32(b)
    out = ah.double() @ bh.double()
    if products == 3:
        al, bl = tf32(a - ah), tf32(b - bh)
        out = out + ah.double() @ bl.double() + al.double() @ bh.double()
    return out.float()


def tail_emulated(ee, w1, a1, w2, a2, wx, ax, wout, bout, k, products,
                  neg=0.01):
    """`edge_tail_plain`'s f32 function with every matmul as mm_tf32."""
    B, N, _, C2 = ee.shape
    F = w2.shape[-1]
    lrelu = torch.nn.functional.leaky_relu
    mm = lambda x, w: mm_tf32(x.reshape(-1, x.shape[-1]), w, products) \
        .reshape(*x.shape[:-1], w.shape[-1])
    diff = ee[..., C2 // 2:]
    h = lrelu(mm(diff, w1) * a1[0] + a1[1], neg)
    h = lrelu(mm(h, w2) * a2[0] + a2[1], neg)
    att = torch.softmax(h, dim=2)
    v = lrelu(mm(ee, wx) * ax[0] + ax[1], neg) * att
    return mm(v.reshape(B, N, k * F), wout.reshape(k * F, F)) + bout[0]


def gate_excess(out, ref) -> float:
    """The largest |out - ref| - (1e-5 + 1e-4 |ref|): <= 0 holds the
    gate."""
    return float(((out - ref).abs() - (GATE_ABS + GATE_REL * ref.abs()))
                 .max())


def test_tf32_rounding_keeps_ten_bits():
    """tf32() rounds to 10 stored mantissa bits, to nearest, ties away
    from zero; x - tf32(x) is exact and its own tf32 is within 2^-11 of
    it, so hi + lo carries about 22 bits of x."""
    x = torch.tensor([1 + 2 ** -11, 1 + 2 ** -10 + 2 ** -11, -(1 + 2 ** -11),
                      1 + 2 ** -12, 3.0], dtype=torch.float32)
    assert tf32(x).tolist() == [1 + 2 ** -10, 1 + 2 ** -9, -(1 + 2 ** -10),
                                1.0, 3.0]
    y = torch.from_numpy(np.random.default_rng(0).standard_normal(
        4096).astype(np.float32))
    hi = tf32(y)
    lo = tf32(y - hi)
    assert float(((hi + lo - y).abs() / y.abs()).max()) < 2 ** -21
    assert float(((hi - y).abs() / y.abs()).max()) > 2 ** -13


@pytest.mark.parametrize("inputs", list(INPUTS))
def test_three_tf32_products_hold_the_f32_gate(inputs):
    """At EdgeConv2's widths (C 64, F2 64, F 128, k 10) the tail with three
    TF32 products a matmul lies within the f32 gate of the plain version,
    at least 5e-6 inside it; with one TF32 product it does not (measured
    on these inputs: the three-product tail 8.0e-6 to 1.0e-5 inside the
    gate, the one-product tail 1.2e-4 to 8.6e-3 beyond it)."""
    offset, scale = INPUTS[inputs]
    args = tail_args(*CASES["EdgeConv2"][:4], 2, 32, offset, scale)
    k = CASES["EdgeConv2"][3]
    ref = edge_tail_plain(*args, k=k)
    three = tail_emulated(*args, k, 3)
    one = tail_emulated(*args, k, 1)
    assert gate_excess(three, ref) <= -GATE_ABS / 2, inputs
    assert gate_excess(one, ref) > 0, inputs


def test_one_tf32_product_misses_by_far_more():
    """The one-product tail's error is at least ten times the
    three-product tail's on EdgeConv2's widths: the gate sees the
    difference, not noise."""
    args = tail_args(*CASES["EdgeConv2"][:4], 2, 32)
    ref = edge_tail_plain(*args, k=10)
    err3 = float((tail_emulated(*args, 10, 3) - ref).abs().max())
    err1 = float((tail_emulated(*args, 10, 1) - ref).abs().max())
    assert err1 > 10 * err3


@pytest.mark.cuda
class TestOnCard:
    @pytest.mark.parametrize("inputs", list(INPUTS))
    @pytest.mark.parametrize("case", list(CASES))
    def test_f32_tail_holds_the_gate(self, case, inputs):
        """Kernel C in f32 mode (on the tensor cores at these widths)
        against its plain version on the card with TF32 off: |err| <=
        1e-5 + 1e-4 |plain| everywhere, and two launches bit-identical."""
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device (kernels have no CPU mode)")
        torch.backends.cuda.matmul.allow_tf32 = False
        C, F2, F, k, B, N = CASES[case]
        args = [t.cuda() for t in tail_args(C, F2, F, k, B, N,
                                            *INPUTS[inputs])]
        out, again = edge_tail(*args, k=k), edge_tail(*args, k=k)
        ref = edge_tail_plain(*args, k=k)
        assert torch.equal(out, again), case
        assert bool(torch.isfinite(out).all())
        assert gate_excess(out, ref) <= 0, (
            case, inputs, float((out - ref).abs().max()))
