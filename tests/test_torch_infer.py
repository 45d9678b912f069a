"""The port's full-video algorithms (``infer.Inpainter``: ff / ip / cp, batched
and host twins) against the JAX package's ``Inpainter``, on a CHN(nb=1,
nf=8, gc=4) whose flax weights the port loads through ``chn_from_jax``, with
the identity aligner of tests/test_infer.py; and the video writer.

Tolerance 1e-5 absolute on frames in [0, 1], for the port's batched loops
against its host twins (the same frames refined in other batches: CPU
convs may pick other blockings by batch size) and against JAX (f32, matmul
precision "float32": the JAX head is one composed conv, the port's five
nested ones, and ip / cp feed inpainted frames back as references); both
read under 1e-6 here. The schedules depend on the masks alone with this
aligner, so both packages take the same rounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from master_thesis_tpu.infer.algorithms import Inpainter as JaxInpainter
from master_thesis_tpu.infer.algorithms import get_indexes_ff as jax_indexes_ff
from master_thesis_tpu.infer.algorithms import get_indexes_ip as jax_indexes_ip
from master_thesis_tpu.models.chn import CHN as JaxCHN
from master_thesis_tpu_torch.infer import Inpainter, get_indexes_ff, get_indexes_ip
from master_thesis_tpu_torch.infer.video import write_frames, write_video
from master_thesis_tpu_torch.models.chn import CHN
from master_thesis_tpu_torch.models.convert import chn_from_jax
from master_thesis_tpu_torch.train.build import chn_infer_fn

H = W = 24
TOL = 1e-5


def test_candidate_orders_match_jax():
    for F in (1, 2, 5, 8, 12, 13):
        t_list = sorted(range(F), key=lambda i: abs(i - F // 2))
        for s in (1, 2, 3):
            for D in (1, 2, 4, 20):
                for t in range(F):
                    assert get_indexes_ff(t, F, s, D) == jax_indexes_ff(t, F, s, D)
                    assert get_indexes_ip(t, t_list, s, D) == jax_indexes_ip(t, t_list, s, D)


def jax_align(x_t, m_t, x_r, m_r):
    v_aligned = 1 - m_r
    return x_r, v_aligned, jnp.clip(v_aligned - (1 - m_t[:, None]), 0, 1)


def port_align(x_t, m_t, x_r, m_r):
    v_aligned = 1 - m_r
    return x_r, v_aligned, torch.clamp(v_aligned - (1 - m_t[:, None]), 0, 1)


@pytest.fixture(scope="module")
def inpainters():
    chn = JaxCHN(nb=1, nf=8, gc=4)
    z = jnp.zeros
    params = chn.init(
        jax.random.PRNGKey(0), z((1, H, W, 3)), z((1, H, W, 1)),
        z((1, 1, H, W, 3)), z((1, 1, H, W, 1)), z((1, 1, H, W, 1)),
    )
    port_chn = CHN(nb=1, nf=8, gc=4, device="cpu")
    np_params = jax.tree_util.tree_map(np.asarray, params["params"])
    port_chn.load_state_dict(chn_from_jax(np_params, nb=1))
    port_chn.eval()
    port = Inpainter(chn_infer_fn(port_chn), port_align, device="cpu")
    return JaxInpainter(chn.apply, params, jax_align), port


def _sequence(F, seed=0):
    """tests/test_infer.py's moving hole."""
    rng = np.random.RandomState(seed)
    y = rng.rand(F, H, W, 3).astype(np.float32)
    m = np.zeros((F, H, W, 1), np.float32)
    for t in range(F):
        m[t, 6 + t: 12 + t, 8:14] = 1
    return (1 - m) * y + m * np.asarray([0.485, 0.456, 0.406], np.float32), m


def _jax(inp, algo, x, m, **kw):
    with jax.default_matmul_precision("float32"):
        return np.asarray(getattr(inp, f"inpaint_{algo}")(x, m, **kw))


@pytest.mark.parametrize("algo,F,kw", [
    ("ff", 6, {}), ("ip", 6, {}), ("cp", 6, {}),
    ("ff", 12, {"compact": 0}),  # C = min(16, 8) = 8 < 12 eligible frames
    ("ff", 6, {"compact": 2}),  # truncation on every round
    ("cp", 6, {"s": 2}),  # parity classes of s = 2 (modulus 2, neighbours +-2)
])
def test_algorithms_match_host_twins_and_jax(inpainters, algo, F, kw):
    jax_inp, port = inpainters
    x, m = _sequence(F)
    got = getattr(port, f"inpaint_{algo}")(x, m, **kw)
    assert got.shape == x.shape and np.isfinite(got).all()
    host = getattr(port, f"inpaint_{algo}_host")(x, m, **kw)
    np.testing.assert_allclose(got, host, atol=TOL)
    np.testing.assert_allclose(got, _jax(jax_inp, algo, x, m, **kw), atol=TOL)


def test_batched_loops_count_rounds_and_stay_on_the_device(inpainters):
    """ff refines each frame once per candidate it takes; the tensor result
    (``as_numpy=False``) is the numpy one; each round costs one sync."""
    _, port = inpainters
    x, m = _sequence(6)
    port.refined = port.syncs = 0
    out = port.inpaint_ff(x, m, as_numpy=False)
    refined, syncs = port.refined, port.syncs
    assert isinstance(out, torch.Tensor)
    np.testing.assert_array_equal(out.numpy(), port.inpaint_ff(x, m))
    assert (port.refined, port.syncs) == (2 * refined, 2 * syncs)
    assert 6 <= refined and 1 <= syncs <= refined  # a round refines at least one frame


def test_write_video_and_frames_round_trip(tmp_path):
    cv2 = pytest.importorskip("cv2")
    F, h, w = 3, 32, 48
    levels = np.asarray([0.2, 0.5, 0.8], np.float32)
    x = np.broadcast_to(levels[:, None, None, None], (F, h, w, 3)).copy()
    x[..., 0] *= 0.5  # distinct R and B, so the RGB -> BGR order shows
    path = write_video(x, "seq_ff", out_dir=str(tmp_path))
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame[:, :, ::-1].astype(np.float32) / 255)
    cap.release()
    assert len(frames) == F and frames[0].shape == (h, w, 3)
    np.testing.assert_allclose(np.stack(frames), x, atol=3 / 255)  # flat MJPG frames
    frame_dir = write_frames(x, "seq", out_dir=str(tmp_path))
    png = cv2.imread(f"{frame_dir}/00001.png")[:, :, ::-1]
    np.testing.assert_array_equal(png, (x[1] * 255).astype(np.uint8))
