"""The port's entry points on real-format data against the JAX package's:
``cli.train`` on the committed D-NeRF and WIM minis (``tests/fixtures/
golden``) for 3 steps with a small model, then the JAX ``test.py`` reads
the port's checkpoint with the same config and scores the eval split as
``cli.test`` does (PSNR, SSIM and MS-SSIM within 1e-4). And the
synthetic scene's ground-truth cache: what one package writes, the other
reads."""
import numpy as np
import pytest

from sk_gs_tpu.data import synthetic as jsynth
from sk_gs_tpu_torch.cli import test as cli_test
from sk_gs_tpu_torch.cli import train as cli_train
from sk_gs_tpu_torch.data import synthetic as tsynth
from tests.test_torch_cli import one_torch_thread  # noqa: F401
from tests.test_torch_cli_jax import jax_entry

FIX = 'tests/fixtures/golden'
SMALL = ['model.capacity=512', 'model.sh_degree=1',
         'model.num_superpoints=16', 'model.num_knn=3', 'model.hyper_dim=2',
         'model.net.depth=2', 'model.net.width=64',
         'train.num_init_points=200', 'raster.pair_capacity=8192']
DATASETS = {
    # 2 train views, 16 px, no val split: evaluated on the train split
    'dnerf': ('configs/d_nerf.yaml', [f'dataset.root={FIX}/dnerf',
                                      'dataset.scene=mini']),
    # 18 train and 2 test cameras over 2 frames, 800 px cut to 100
    'wim': ('configs/wim.yaml', [f'dataset.root={FIX}/wim',
                                 'dataset.scene=mini',
                                 'dataset.frame_ranges=[0,2]',
                                 'dataset.downscale=8']),
}


@pytest.mark.parametrize('name', list(DATASETS))
def test_cli_train_then_jax_test(name, tmp_path):
    config, data = DATASETS[name]
    res = cli_train.main(['-c', config, '--device', 'cpu', '--steps', '3',
                          '--set', f'output_dir={tmp_path}', *data, *SMALL])
    assert np.isfinite(res['PSNR'])
    out = next(p for p in tmp_path.iterdir() if p.is_dir())
    args = ['-c', str(out / 'config.yaml'), '--load',
            str(out / 'checkpoints' / 'last.npz')]
    got = cli_test.main(args + ['--device', 'cpu', '--out',
                                str(tmp_path / 'port.json')])
    ref = jax_entry('test').main(args + ['--out', str(tmp_path / 'jax.json')])
    assert set(got) == set(ref)
    for k in ('PSNR', 'SSIM', 'MS-SSIM'):
        assert abs(got[k] - ref[k]) < 1e-4, (k, got[k], ref[k])
    for k in ('stage', 'step', 'capacity', 'n_alive'):
        assert got[k] == ref[k], k


@pytest.mark.parametrize('background', ['white', 'random'])
def test_ground_truth_cache_is_shared(background, tmp_path):
    """Each package reads the frames the other cached, under the same key
    and files; dynamic backgrounds cache RGBA."""
    kw = dict(num_links=2, gauss_per_link=20, num_frames=3, h=16, w=16,
              pair_capacity=2 ** 11, chunk=64, background=background,
              cache_dir=str(tmp_path))
    port, _, _ = tsynth.make_synthetic_scene(seed=1, device='cpu', **kw)
    key = tsynth.cache_key(1, 2, 20, 3, 16, 16, background, False)
    assert (tmp_path / f'{key}.npz').exists()
    assert not (tmp_path / f'{key}.frames').exists()
    jax_read, _, _ = jsynth.make_synthetic_scene(seed=1, **kw)
    np.testing.assert_array_equal(np.asarray(jax_read.images),
                                  port.images.numpy())
    assert port.images.shape[-1] == (4 if background == 'random' else 3)

    jax_wrote, _, _ = jsynth.make_synthetic_scene(seed=2, **kw)
    port_read, _, _ = tsynth.make_synthetic_scene(seed=2, device='cpu', **kw)
    np.testing.assert_array_equal(port_read.images.numpy(),
                                  np.asarray(jax_wrote.images))
    # a frame cached alone (a cut-off run) is read, the rest rendered
    key3 = tsynth.cache_key(3, 2, 20, 3, 16, 16, background, False)
    (tmp_path / f'{key3}.frames').mkdir()
    first, _, _ = jsynth.make_synthetic_scene(seed=3, **{**kw,
                                                         'cache_dir': None})
    np.save(tmp_path / f'{key3}.frames' / 'f0000.npy',
            np.asarray(first.images[0]))
    part, _, _ = tsynth.make_synthetic_scene(seed=3, device='cpu', **kw)
    np.testing.assert_array_equal(part.images[0].numpy(),
                                  np.asarray(first.images[0]))
    assert (tmp_path / f'{key3}.npz').exists()
