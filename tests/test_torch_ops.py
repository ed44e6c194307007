"""Port parity, math ops: sk_gs_tpu_torch.ops vs sk_gs_tpu.ops on the same
numpy inputs (float32, atol 1e-6: elementwise formulas in the same order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sk_gs_tpu.ops import quaternion as jq
from sk_gs_tpu.ops import se3 as jse3
from sk_gs_tpu.ops import sh as jsh
from sk_gs_tpu.ops import transforms as jtf
from sk_gs_tpu_torch.ops import quaternion as tq
from sk_gs_tpu_torch.ops import se3 as tse3
from sk_gs_tpu_torch.ops import sh as tsh
from sk_gs_tpu_torch.ops import transforms as ttf

ATOL = 1e-6


def close(t, j):
    np.testing.assert_allclose(t.detach().cpu().numpy(), np.asarray(j),
                               atol=ATOL, rtol=0)


def quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q[0] = 0.0                       # the eps-guarded zero row
    q[1] = [0.0, 0.0, 0.0, 1.0]      # identity
    return q


def test_quaternion_normalize_multiply_apply(rng):
    q1, q2 = quats(rng, 64), quats(rng, 64)
    v = rng.normal(size=(64, 3)).astype(np.float32)
    close(tq.normalize(torch.from_numpy(q1)), jq.normalize(jnp.asarray(q1)))
    close(tq.multiply(torch.from_numpy(q1), torch.from_numpy(q2)),
          jq.multiply(jnp.asarray(q1), jnp.asarray(q2)))
    qn = np.array(jq.normalize(jnp.asarray(q1)))
    close(tq.apply(torch.from_numpy(qn), torch.from_numpy(v)),
          jq.apply(jnp.asarray(qn), jnp.asarray(v)))


@pytest.mark.parametrize('pre_normalize', [True, False])
def test_quaternion_to_matrix(rng, pre_normalize):
    q = quats(rng, 64)
    close(tq.to_matrix(torch.from_numpy(q), pre_normalize),
          jq.to_matrix(jnp.asarray(q), pre_normalize))


def test_slerp(rng):
    q1 = quats(rng, 32)[2:]
    q2 = q1 + rng.normal(size=q1.shape).astype(np.float32) * 0.3
    q2[0] = q1[0]                    # sin(theta) ~ 0: the lerp branch
    q2[1] = -q1[1]                   # antipodal: sign flip
    t = rng.uniform(size=(q1.shape[0],)).astype(np.float32)
    close(tq.slerp(torch.from_numpy(q1), torch.from_numpy(q2), torch.from_numpy(t)),
          jq.slerp(jnp.asarray(q1), jnp.asarray(q2), jnp.asarray(t)))


def test_se3_ops(rng):
    phi = rng.normal(size=(32, 3)).astype(np.float32)
    phi[0] = 0.0
    phi[1] = 1e-5
    close(tse3.so3_exp(torch.from_numpy(phi)), jse3.so3_exp(jnp.asarray(phi)))
    close(tse3.se3_identity((3,)), jse3.se3_identity((3,)))
    T1 = np.concatenate([rng.normal(size=(32, 3)), quats(rng, 32)], -1).astype(np.float32)
    T2 = np.concatenate([rng.normal(size=(32, 3)), quats(rng, 32)], -1).astype(np.float32)
    p = rng.normal(size=(32, 3)).astype(np.float32)
    close(tse3.se3_mul(torch.from_numpy(T1), torch.from_numpy(T2)),
          jse3.se3_mul(jnp.asarray(T1), jnp.asarray(T2)))
    close(tse3.se3_act(torch.from_numpy(T1), torch.from_numpy(p)),
          jse3.se3_act(jnp.asarray(T1), jnp.asarray(p)))
    a = rng.uniform(size=(32,)).astype(np.float32)
    T1n = T1.copy()
    T1n[:, 3:] = np.asarray(jq.normalize(jnp.asarray(T1[:, 3:])))
    T2n = T2.copy()
    T2n[:, 3:] = np.asarray(jq.normalize(jnp.asarray(T2[:, 3:])))
    close(tse3.se3_interpolate(torch.from_numpy(T1n), torch.from_numpy(T2n),
                               torch.from_numpy(a)),
          jse3.se3_interpolate(jnp.asarray(T1n), jnp.asarray(T2n), jnp.asarray(a)))


@pytest.mark.parametrize('deg', [0, 1, 2, 3])
def test_eval_sh_and_color(rng, deg):
    nb = (deg + 1) ** 2
    sh = rng.normal(size=(50, nb, 3)).astype(np.float32) * 0.5
    pts = rng.normal(size=(50, 3)).astype(np.float32)
    cam = np.asarray([0.3, -0.2, -4.0], np.float32)
    d = pts - cam
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    close(tsh.eval_sh(deg, torch.from_numpy(sh), torch.from_numpy(d)),
          jsh.eval_sh(deg, jnp.asarray(sh), jnp.asarray(d)))
    close(tsh.sh_to_color(deg, torch.from_numpy(sh), torch.from_numpy(pts),
                          torch.from_numpy(cam)),
          jsh.sh_to_color(deg, jnp.asarray(sh), jnp.asarray(pts), jnp.asarray(cam)))


def test_sh_mask_and_rgb(rng):
    for active in range(4):
        close(tsh.sh_degree_mask(3, active), jsh.sh_degree_mask(3, jnp.asarray(active)))
    rgb = rng.uniform(size=(10, 3)).astype(np.float32)
    close(tsh.rgb_to_sh(torch.from_numpy(rgb)), jsh.rgb_to_sh(jnp.asarray(rgb)))


@pytest.mark.parametrize('coord', ['opencv', 'opengl'])
def test_camera_builders(coord):
    eye, at, up = [0.3, -0.2, -4.0], [0.0, 0.1, 0.0], [0.0, -1.0, 0.0]
    close(ttf.look_at(eye, at, up, coord=coord),
          jtf.look_at(jnp.asarray(eye), jnp.asarray(at), jnp.asarray(up),
                      coord=coord))
    close(ttf.perspective_opencv(0.8, size=(64, 48)),
          jtf.perspective_opencv(jnp.asarray(0.8), size=(64, 48)))
