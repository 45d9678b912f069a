"""The port's tail backward (``TailFunction`` on the CPU, i.e. the plain
backward ``tail_bwd_plain``) against ``jax.grad`` through the JAX
``make_hybrid_tail``, whose backward is the fused ``tail_bwd_pallas`` in
interpret mode. f32 on both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from master_thesis_tpu.ops.pallas_tail import make_hybrid_tail
from master_thesis_tpu_torch.ops import conv_bwd, fragments
from master_thesis_tpu_torch.ops import tail as ttail
from master_thesis_tpu_torch.ops import tail_bwd
from tests.test_torch_tail import _tail_params

_JAX_NAMES = {"up1": "upconv1", "up2": "upconv2", "hr": "hr_conv", "last": "conv_last"}


@pytest.mark.parametrize("n,h,w", [(2, 8, 8), (1, 6, 10)], ids=["square", "rectangular"])
def test_tail_function_grads_match_jax(rng, n, h, w):
    """dx and all 8 parameter grads; the upsample-convs' weight grads are the
    original 3x3 kernels' (the JAX kernel folds its 4-phase grads back
    through ``fused_upsample_conv_kernel_adjoint``). Tolerance 1e-4
    relative and absolute, the JAX test's own for this backward
    (tests/test_pallas_tail.py:50)."""
    nf = 16
    p = _tail_params(rng, nf)
    y = rng.randn(n, h, w, nf).astype(np.float32)
    cot = rng.randn(n, 4 * h, 4 * w, 3).astype(np.float32)
    tail = make_hybrid_tail(jnp.float32, interpret=True)
    with jax.default_matmul_precision("highest"):
        want_x, want_p = jax.grad(
            lambda a, q: jnp.vdot(tail(a, q), jnp.asarray(cot)), argnums=(0, 1)
        )(jnp.asarray(y), {k: jnp.asarray(v) for k, v in p.items()})

    params = []
    for name in tail_bwd.PARAM_NAMES:
        key, kind = name.rsplit("_", 1)
        a = p[f"{_JAX_NAMES[key]}_{'kernel' if kind == 'w' else 'bias'}"]
        t = torch.from_numpy(a).permute(3, 2, 0, 1).contiguous() if kind == "w" else torch.from_numpy(a).clone()
        params.append(t.requires_grad_())
    x = torch.from_numpy(y).permute(0, 3, 1, 2).contiguous().requires_grad_()
    out = tail_bwd.TailFunction.apply(x, torch.float32, *params)
    assert out.shape == (n, 3, 4 * h, 4 * w)
    out.backward(torch.from_numpy(cot).permute(0, 3, 1, 2))
    np.testing.assert_allclose(x.grad.permute(0, 2, 3, 1).numpy(), np.asarray(want_x), rtol=1e-4, atol=1e-4)
    for name, t in zip(tail_bwd.PARAM_NAMES, params):
        key, kind = name.rsplit("_", 1)
        ref = np.asarray(want_p[f"{_JAX_NAMES[key]}_{'kernel' if kind == 'w' else 'bias'}"])
        ref = ref.transpose(3, 2, 0, 1) if kind == "w" else ref
        np.testing.assert_allclose(t.grad.numpy(), ref, rtol=1e-4, atol=1e-4, err_msg=name)


def test_pack_adjoint_is_the_flipped_transposed_kernel(rng):
    """The adjoint B matrix holds, at row ``(ky, kx, o)`` and column ``c``,
    ``W[o, c, 2 - ky, 2 - kx]``; conv_last's 3 rows per tap pad to 32."""
    w = torch.from_numpy(rng.randn(3, 64, 3, 3).astype(np.float32))
    mat = fragments.unpack(conv_bwd.pack_adjoint(w, torch.float32, o_pad=32), 9 * 32, 64)
    mat = mat.reshape(3, 3, 32, 64)
    assert torch.equal(mat[:, :, 3:], torch.zeros_like(mat[:, :, 3:]))
    assert torch.equal(mat[0, 2, 1, 5], w[1, 5, 2, 0])
    assert torch.equal(mat[:, :, :3].permute(2, 3, 0, 1), w.flip(2, 3))


def test_tail_bwd_flops_counts_phase_form():
    """184 GFLOP for the train step's tail backward (8 frames, 64x64):
    adjoint and weight grads at the forward's phase-form count (62 each)
    plus the recompute of h1..h3."""
    assert round(tail_bwd.tail_bwd_flops(8, 64, 64) / 1e9) == 184
    assert tail_bwd.tail_bwd_flops(8, 64, 64) > 2 * ttail.tail_flops(8, 64, 64)
