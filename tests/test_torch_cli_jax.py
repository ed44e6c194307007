"""The port's serving entry points against the JAX package's, on one
checkpoint that the port's ``cli.train`` wrote (``configs/
synthetic_smoke.yaml`` on the CPU): the JAX ``test.py`` loads it into its
trainer's template and scores the split as ``cli.test`` does (PSNR, SSIM
and MS-SSIM within 1e-4, the same keys), and the JAX ``render_repose.py``
renders the same orbit, time sweep and pose keyframes as
``cli.render_repose`` (frames within 1/255). The JAX side blends with XLA
on the CPU (``use_pallas: auto``)."""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from sk_gs_tpu_torch.cli import render_repose as cli_repose
from sk_gs_tpu_torch.cli import test as cli_test
from sk_gs_tpu_torch.cli import train as cli_train
from sk_gs_tpu_torch.utils.png import read_png
from tests.test_torch_cli import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
CONFIG = 'configs/synthetic_smoke.yaml'
POSES = [{'joint_deltas': [[0.0, 0.0, 0.0], [0.0, 0.0, 0.0]]},
         {'joint_deltas': [[0.4, 0.1, -0.3], [0.1, 0.2, 0.0]]}]


def jax_entry(name: str):
    """The JAX package's entry-point script ``name``.py at the repo root
    (``test`` is also a standard-library package, so load by path)."""
    spec = importlib.util.spec_from_file_location(f'jax_cli_{name}',
                                                  ROOT / f'{name}.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope='module')
def checkpoint(tmp_path_factory):
    root = tmp_path_factory.mktemp('run')
    cli_train.main(['-c', CONFIG, '--device', 'cpu', '--set',
                    f'output_dir={root}', f'dataset.root={root}'])
    out = root / 'synthetic_smoke'
    return out / 'config.yaml', out / 'checkpoints' / 'last.npz'


def test_cli_test_matches_jax_test(checkpoint, tmp_path):
    config, ckpt = checkpoint
    got = cli_test.main(['-c', str(config), '--load', str(ckpt), '--device',
                         'cpu', '--out', str(tmp_path / 'port.json')])
    ref = jax_entry('test').main(['-c', str(config), '--load', str(ckpt),
                                  '--out', str(tmp_path / 'jax.json')])
    assert set(got) == set(ref)
    assert json.loads((tmp_path / 'port.json').read_text()).keys() == \
        json.loads((tmp_path / 'jax.json').read_text()).keys()
    for k in ('PSNR', 'SSIM', 'MS-SSIM', 'SSIM (border-cropped)'):
        assert abs(got[k] - ref[k]) < 1e-4, (k, got[k], ref[k])
    for k in ('stage', 'step', 'capacity', 'pair_capacity', 'n_alive',
              'LPIPS weights', 'LPIPS (alex)', 'LPIPS (vgg)'):
        assert got[k] == ref[k], k
    assert got['FPS'] > 0


def test_render_repose_matches_jax(checkpoint, tmp_path):
    config, ckpt = checkpoint
    poses = tmp_path / 'poses.json'
    poses.write_text(json.dumps(POSES))
    args = ['-c', str(config), '--load', str(ckpt), '--num-frames', '4',
            '--orbit', '--time-sweep', '--pose-json', str(poses)]
    out = cli_repose.main(args + ['--out', str(tmp_path / 'port'),
                                  '--device', 'cpu'])
    jax_entry('render_repose').main(args + ['--out', str(tmp_path / 'jax')])
    assert [p.name for p in out['paths']] == [f'frame_{i:04d}.png'
                                              for i in range(4)]
    for p in out['paths']:
        got = read_png(p).astype(int)
        ref = np.asarray(Image.open(tmp_path / 'jax' / p.name)).astype(int)
        assert got.shape == ref.shape == (48, 48, 3)
        assert np.abs(got - ref).max() <= 1, p.name
        np.testing.assert_array_equal(np.asarray(Image.open(p)), got)
    # the pose moves the render: the last frame with and without it
    still = cli_repose.main(['-c', str(config), '--load', str(ckpt),
                             '--num-frames', '4', '--orbit', '--time-sweep',
                             '--out', str(tmp_path / 'still'), '--device',
                             'cpu'])
    assert not np.array_equal(read_png(out['paths'][-1]),
                              read_png(still['paths'][-1]))
