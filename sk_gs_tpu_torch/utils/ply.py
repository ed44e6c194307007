"""3DGS-standard PLY export and import with numpy only (a copy of
``sk_gs_tpu/utils/ply.py``).

A binary_little_endian vertex element with the attributes x, y, z, nx, ny,
nz, f_dc_*, f_rest_*, opacity, scale_*, rot_*: the interchange format of
the 3DGS tools. Raw (pre-activation) values are stored. ``load_point_ply``
reads a plain point cloud (ascii or binary, float or uchar colours).
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np


def gaussian_ply_fields(num_rest: int) -> list:
    fields = ['x', 'y', 'z', 'nx', 'ny', 'nz']
    fields += [f'f_dc_{i}' for i in range(3)]
    fields += [f'f_rest_{i}' for i in range(num_rest * 3)]
    fields += ['opacity']
    fields += [f'scale_{i}' for i in range(3)]
    fields += [f'rot_{i}' for i in range(4)]
    return fields


def save_gaussian_ply(path: str | Path, params: Dict[str, np.ndarray],
                      alive: np.ndarray):
    """params: raw leaves xyz [N,3], f_dc [N,1,3], f_rest [N,R,3],
    opacity [N,1], scaling [N,3], rotation [N,4]; only alive rows written."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    sel = np.asarray(alive)
    xyz = np.asarray(params['xyz'])[sel]
    n = xyz.shape[0]
    normals = np.zeros_like(xyz)
    # channel-major flatten (transpose(1, 2).flatten), as the 3DGS tools do
    f_dc = np.asarray(params['f_dc'])[sel].transpose(0, 2, 1).reshape(n, -1)
    f_rest = np.asarray(params['f_rest'])[sel].transpose(0, 2, 1).reshape(n, -1)
    opacity = np.asarray(params['opacity'])[sel].reshape(n, 1)
    scaling = np.asarray(params['scaling'])[sel]
    rotation = np.asarray(params['rotation'])[sel]

    attrs = np.concatenate(
        [xyz, normals, f_dc, f_rest, opacity, scaling, rotation],
        axis=1).astype('<f4')
    fields = gaussian_ply_fields(f_rest.shape[1] // 3)
    assert attrs.shape[1] == len(fields)

    header = ['ply', 'format binary_little_endian 1.0',
              f'element vertex {n}']
    header += [f'property float {f}' for f in fields]
    header += ['end_header']
    with path.open('wb') as f:
        f.write(('\n'.join(header) + '\n').encode('ascii'))
        f.write(attrs.tobytes())


def load_gaussian_ply(path: str | Path) -> Dict[str, np.ndarray]:
    """Returns raw param dict (numpy). Supports the binary_little_endian
    float32 layout written above and by the Inria pipeline."""
    path = Path(path)
    with path.open('rb') as f:
        line = f.readline().strip()
        assert line == b'ply', f'not a ply file: {path}'
        fields, n = [], 0
        fmt = None
        while True:
            line = f.readline().strip().decode('ascii')
            if line.startswith('format'):
                fmt = line.split()[1]
            elif line.startswith('element vertex'):
                n = int(line.split()[-1])
            elif line.startswith('property float'):
                fields.append(line.split()[-1])
            elif line == 'end_header':
                break
        assert fmt == 'binary_little_endian', f'unsupported format {fmt}'
        data = np.frombuffer(f.read(n * len(fields) * 4), dtype='<f4')
        data = data.reshape(n, len(fields))

    idx = {name: i for i, name in enumerate(fields)}
    xyz = data[:, [idx['x'], idx['y'], idx['z']]]
    f_dc_cols = sorted([k for k in idx if k.startswith('f_dc_')],
                       key=lambda s: int(s.split('_')[-1]))
    f_rest_cols = sorted([k for k in idx if k.startswith('f_rest_')],
                         key=lambda s: int(s.split('_')[-1]))
    f_dc = data[:, [idx[k] for k in f_dc_cols]].reshape(n, 3, 1) \
        .transpose(0, 2, 1)
    r = len(f_rest_cols) // 3
    f_rest = data[:, [idx[k] for k in f_rest_cols]].reshape(n, 3, r) \
        .transpose(0, 2, 1)
    scale_cols = sorted([k for k in idx if k.startswith('scale_')],
                        key=lambda s: int(s.split('_')[-1]))
    rot_cols = sorted([k for k in idx if k.startswith('rot_')],
                      key=lambda s: int(s.split('_')[-1]))
    return {
        'xyz': xyz,
        'f_dc': f_dc,
        'f_rest': f_rest,
        'opacity': data[:, idx['opacity']][:, None],
        'scaling': data[:, [idx[k] for k in scale_cols]],
        'rotation': data[:, [idx[k] for k in rot_cols]],
    }


def load_point_ply(path: str | Path):
    """Plain point-cloud PLY -> (xyz [N,3] f32, rgb [N,3] f32 in [0,1]),
    the initial points of ``train.init_ply``. Handles ascii and
    binary_little_endian with mixed float/uchar properties; colors default
    to 0.5 when absent."""
    path = Path(path)
    with path.open('rb') as f:
        assert f.readline().strip() == b'ply', f'not a ply file: {path}'
        fmt, n = None, 0
        props = []  # (name, dtype)
        _types = {'float': '<f4', 'float32': '<f4', 'double': '<f8',
                  'uchar': 'u1', 'uint8': 'u1', 'char': 'i1',
                  'short': '<i2', 'ushort': '<u2', 'int': '<i4',
                  'uint': '<u4'}
        in_vertex = False
        while True:
            line = f.readline().strip().decode('ascii')
            if line.startswith('format'):
                fmt = line.split()[1]
            elif line.startswith('element'):
                parts = line.split()
                in_vertex = parts[1] == 'vertex'
                if in_vertex:
                    n = int(parts[2])
            elif line.startswith('property') and in_vertex:
                _, typ, name = line.split()
                props.append((name, _types[typ]))
            elif line == 'end_header':
                break
        dt = np.dtype([(name, t) for name, t in props])
        if fmt == 'binary_little_endian':
            rec = np.frombuffer(f.read(n * dt.itemsize), dtype=dt, count=n)
        elif fmt == 'ascii':
            rows = [f.readline().split() for _ in range(n)]
            rec = np.array([tuple(r) for r in rows], dtype=dt)
        else:
            raise ValueError(f'unsupported ply format {fmt}')
    xyz = np.stack([rec['x'], rec['y'], rec['z']], -1).astype(np.float32)
    names = {p[0] for p in props}
    if {'red', 'green', 'blue'} <= names:
        rgb = np.stack([rec['red'], rec['green'], rec['blue']],
                       -1).astype(np.float32)
        if rgb.max() > 1.0 + 1e-6:
            rgb = rgb / 255.0
    else:
        rgb = np.full_like(xyz, 0.5)
    return xyz, rgb
