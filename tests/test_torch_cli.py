"""The port's training entry point end to end on the CPU:
``python -m sk_gs_tpu_torch.cli.train -c configs/synthetic_smoke.yaml
--device cpu`` runs the whole 180-step schedule (the point-cloud restart,
the skeleton initialisation at 50 + 50 iterations, ``sk_init`` and ``sk``)
and writes the JAX package's files; a run resumed from its step-100
checkpoint (inside ``sp``, before the skeleton initialisation) reaches the
uninterrupted run's ``last.npz`` bit for bit: the stage flags, Adam, the
smooth loss's KNN and the noise generator all come back; and so does a run
with Adan, two views a step, bf16 nets, the time noise and every
regularizer (their generators and Adan's state come back too)."""
import json
import math

import numpy as np
import pytest
import torch
import yaml

from sk_gs_tpu_torch.cli import test as cli_test
from sk_gs_tpu_torch.cli import train as cli_train
from sk_gs_tpu_torch.framework.checkpoint import load, step_of
from sk_gs_tpu_torch.framework.config import make_config
from sk_gs_tpu_torch.utils.ply import load_gaussian_ply

CONFIG = 'configs/synthetic_smoke.yaml'
# the keys of the JAX package's train results.json (untrained LPIPS)
RESULT_KEYS = {'PSNR', 'SSIM', 'SSIM (border-cropped)', 'MS-SSIM',
               'LPIPS (alex)', 'LPIPS (vgg)', 'LPIPS weights',
               'LPIPS (alex) [uncalibrated]', 'LPIPS (vgg) [uncalibrated]',
               'best_PSNR', 'train_time_s'}
TEST_KEYS = RESULT_KEYS - {'best_PSNR', 'train_time_s'} | {
    'FPS', 'stage', 'step', 'capacity', 'pair_capacity', 'n_alive'}


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    """One torch thread for the module: the port's CPU runs are thousands
    of small ops, which gain nothing from more threads, and beside the
    other test workers their threads stall each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def train_args(root, *extra):
    return ['-c', CONFIG, '--device', 'cpu', '--set', f'output_dir={root}',
            f'dataset.root={root}', *extra]


@pytest.fixture(scope='module')
def smoke_run(tmp_path_factory):
    root = tmp_path_factory.mktemp('run')
    result = cli_train.main(train_args(root))
    return root / 'synthetic_smoke', result


def test_train_writes_its_files(smoke_run):
    out, result = smoke_run
    ck = out / 'checkpoints'
    assert sorted(p.name for p in ck.iterdir()) == [
        'best.npz', 'checkpoint_00000100.npz', 'init.npz', 'last.npz',
        'sk_init.npz']
    # the snapshots after the restart (before step 40) and the skeleton
    # initialisation (before step 111), and the last step
    assert step_of(load(ck / 'init.npz')) == 39
    sk_init = load(ck / 'sk_init.npz')
    assert step_of(sk_init) == 110
    assert bool(sk_init['state/flags/skeleton_initialized'])
    assert sk_init['state/model/joint_depth'].max() > 0
    assert step_of(load(ck / 'last.npz')) == 180
    for name in ('config.yaml', 'metrics.jsonl', 'last.ply', 'results.json'):
        assert (out / name).exists(), name
    ply = load_gaussian_ply(out / 'last.ply')
    last = load(ck / 'last.npz')
    np.testing.assert_array_equal(
        ply['xyz'], last['state/model/params/xyz'][last['state/model/alive']])


def test_results_json_has_the_jax_keys(smoke_run):
    out, result = smoke_run
    saved = json.loads((out / 'results.json').read_text())
    assert set(saved) == RESULT_KEYS
    assert saved['LPIPS weights'] == 'untrained-fallback'
    for k, v in saved.items():
        if k in ('LPIPS (alex)', 'LPIPS (vgg)'):
            assert v is None
        elif k != 'LPIPS weights':
            assert math.isfinite(v), k
    assert saved['PSNR'] > 20.0
    assert saved['best_PSNR'] == max(saved['PSNR'], saved['best_PSNR'])


def test_metrics_log_and_config(smoke_run):
    out, _ = smoke_run
    lines = [json.loads(x) for x in
             (out / 'metrics.jsonl').read_text().splitlines()]
    assert [x['step'] for x in lines] == list(range(20, 181, 20))
    assert [x['stage'] for x in lines][::4] == ['init', 'sp', 'sk']
    assert all(x['ms_per_step'] > 0 and math.isfinite(x['loss'])
               for x in lines)
    cfg = make_config(CONFIG, [f'output_dir={out.parent}',
                               f'dataset.root={out.parent}'])
    text = (out / 'config.yaml').read_text()
    assert yaml.safe_load(text) == cfg
    assert make_config(str(out / 'config.yaml')) == cfg


def test_resume_reaches_the_same_last_checkpoint(smoke_run, tmp_path):
    """From the step-100 checkpoint (``sp``, all-zero smooth-loss KNN) across
    the skeleton initialisation to step 180: every array of ``last.npz``
    equal bit for bit (the CPU runs the same ops in the same order)."""
    out, result = smoke_run
    resumed = cli_train.main(train_args(
        tmp_path, '--resume', str(out / 'checkpoints/checkpoint_00000100.npz')))
    a = load(out / 'checkpoints/last.npz')
    b = load(tmp_path / 'synthetic_smoke/checkpoints/last.npz')
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert resumed['PSNR'] == result['PSNR']
    assert resumed['best_PSNR'] == result['best_PSNR']
    # the same with Adan (its four moment fields), two views a step, the
    # nets in bfloat16, the time noise of a net that is not is_blender and
    # every regularizer on (the time and regularizer generators): 120
    # steps straight, and from step 100 to 120 (the skeleton
    # initialisation before step 111 included)
    options = ['train.optimizer=adan', 'train.batch_views=2',
               'train.precision=bf16', 'model.is_blender=false',
               *(f'loss.{k}=0.1' for k in ('elastic', 'acc', 'arap',
                                           'arap_p', 're_pos', 'jp_dist',
                                           'sp_arap_t', 'sp_arap_ct'))]
    runs = {}
    for name, extra in (('straight', []), ('resumed', ['--resume'])):
        root = tmp_path / name
        if extra:
            extra = extra + [str(tmp_path / 'straight/synthetic_smoke/'
                                 'checkpoints/checkpoint_00000100.npz')]
        cli_train.main(train_args(root, *options, '--steps', '120',
                                  *extra))
        runs[name] = load(root / 'synthetic_smoke/checkpoints/last.npz')
    a, b = runs['straight'], runs['resumed']
    assert set(a) == set(b) and 'state/opt/prev_grad/xyz' in a
    assert 'state/port/time_gen_state' in a and step_of(a) == 120
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_truncated_run(tmp_path):
    """``--steps`` stops the schedule early; the last checkpoint is there."""
    res = cli_train.main(train_args(tmp_path, '--steps', '12'))
    last = load(tmp_path / 'synthetic_smoke/checkpoints/last.npz')
    assert step_of(last) == 12 and int(last['state/opt/count']) == 12
    assert set(res) == RESULT_KEYS


def test_cli_test_at_full_capacity(smoke_run, tmp_path):
    """``--full-capacity`` pads the checkpoint with dead slots: the same
    metrics at twice the capacity."""
    out, _ = smoke_run
    args = ['-c', str(out / 'config.yaml'), '--load',
            str(out / 'checkpoints/last.npz'), '--device', 'cpu']
    own = cli_test.main(args + ['--out', str(tmp_path / 'a.json')])
    big = cli_test.main(args + ['--out', str(tmp_path / 'b.json'),
                                '--full-capacity', '--set',
                                'model.capacity=1024'])
    assert set(own) == TEST_KEYS
    assert (own['capacity'], big['capacity']) == (512, 1024)
    assert own['n_alive'] == big['n_alive']
    for k in ('PSNR', 'SSIM', 'MS-SSIM'):
        np.testing.assert_allclose(big[k], own[k], rtol=1e-6, err_msg=k)
    assert (own['stage'], own['step']) == ('sk', 180)
