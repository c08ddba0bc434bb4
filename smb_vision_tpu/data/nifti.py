"""NIfTI-1/2 volume IO, implemented from the format spec (no nibabel
dependency — the reference delegates decode to MONAI's LoadImaged/ITK stack,
mim.py:146; here it's first-party).

Supports .nii / .nii.gz, NIfTI-1 and NIfTI-2 headers, both endiannesses,
the common datatypes, scl_slope/inter scaling, and sform/qform affines.
Returns the raw array in file (x,y,z[,t]) order plus the 4x4 voxel->world
affine; orientation handling lives in data/preprocess.py.
"""

from __future__ import annotations

import gzip
import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Tuple, Union

import numpy as np

_DTYPES = {
    2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32, 64: np.float64,
    256: np.int8, 512: np.uint16, 768: np.uint32, 1024: np.int64,
    1280: np.uint64,
}


@dataclass
class NiftiImage:
    data: np.ndarray          # file-order (x, y, z, ...) array
    affine: np.ndarray        # 4x4 voxel -> world (RAS mm)
    spacing: Tuple[float, float, float]

    @property
    def shape(self):
        return self.data.shape


def _quaternion_affine(b, c, d, qx, qy, qz, dx, dy, dz, qfac):
    a2 = 1.0 - (b * b + c * c + d * d)
    a = np.sqrt(max(a2, 0.0))
    R = np.array([
        [a*a+b*b-c*c-d*d, 2*b*c-2*a*d,     2*b*d+2*a*c],
        [2*b*c+2*a*d,     a*a+c*c-b*b-d*d, 2*c*d-2*a*b],
        [2*b*d-2*a*c,     2*c*d+2*a*b,     a*a+d*d-b*b-c*c],
    ])
    aff = np.eye(4)
    aff[:3, :3] = R * np.array([dx, dy, dz * (qfac if qfac != 0 else 1.0)])
    aff[:3, 3] = (qx, qy, qz)
    return aff


def _read_bytes(path: Union[str, Path]) -> bytes:
    path = Path(path)
    raw = path.read_bytes()
    if raw[:2] == b"\x1f\x8b":
        raw = gzip.decompress(raw)
    return raw


def load_nifti(path: Union[str, Path]) -> NiftiImage:
    raw = _read_bytes(path)
    sizeof_hdr = struct.unpack_from("<i", raw, 0)[0]
    if sizeof_hdr == 348:
        endian = "<"
    elif struct.unpack_from(">i", raw, 0)[0] == 348:
        endian = ">"
    elif sizeof_hdr == 540 or struct.unpack_from(">i", raw, 0)[0] == 540:
        return _load_nifti2(raw)
    else:
        raise ValueError(f"{path}: not a NIfTI file (sizeof_hdr={sizeof_hdr})")

    u = lambda fmt, off: struct.unpack_from(endian + fmt, raw, off)  # noqa
    dim = u("8h", 40)
    ndim = dim[0]
    # spec: dim[0] in 1..7; out-of-range means a corrupt header (a
    # dim[0]>7 would silently truncate the shape, 0 would "load" a
    # scalar) — reject, matching csrc/ctloader.cpp::parse_nifti
    if not 1 <= ndim <= 7:
        raise ValueError(f"{path}: bad NIfTI dim[0]={ndim} (must be 1..7)")
    shape = tuple(int(x) for x in dim[1:1 + ndim])
    if any(s < 1 for s in shape):
        raise ValueError(f"{path}: bad NIfTI shape {shape}")
    datatype = u("h", 70)[0]
    pixdim = u("8f", 76)
    voff_f = u("f", 108)[0]
    # single-file .nii: data must start at/after the 348-byte header
    # (vox_offset 0 would silently re-read header bytes as voxels);
    # the isfinite check keeps NaN/inf from reaching int()
    if not (np.isfinite(voff_f) and 348 <= voff_f <= len(raw)):
        raise ValueError(f"{path}: bad NIfTI vox_offset {voff_f}")
    vox_offset = int(voff_f)
    scl_slope, scl_inter = u("f", 112)[0], u("f", 116)[0]
    qform_code, sform_code = u("h", 252)[0], u("h", 254)[0]
    qb, qc, qd = u("3f", 256)
    qx, qy, qz = u("3f", 268)
    srow = np.array([u("4f", 280), u("4f", 296), u("4f", 312)])

    if datatype not in _DTYPES:
        raise ValueError(f"{path}: unsupported NIfTI datatype {datatype}")
    dt = np.dtype(_DTYPES[datatype]).newbyteorder(endian)
    count = int(np.prod(shape))
    data = np.frombuffer(raw, dtype=dt, count=count, offset=vox_offset)
    data = data.reshape(shape, order="F")

    # NIfTI spec: scl_slope == 0 means "no scaling" — ignore BOTH fields
    # (nibabel behavior); non-finite values are uninitialized header bytes
    # (a NaN slope would silently turn the whole volume into NaN)
    if (np.isfinite(scl_slope) and np.isfinite(scl_inter)
            and scl_slope != 0.0
            and (scl_slope != 1.0 or scl_inter != 0.0)):
        data = data.astype(np.float32) * scl_slope + scl_inter

    if sform_code > 0:
        affine = np.eye(4)
        affine[:3] = srow
    elif qform_code > 0:
        affine = _quaternion_affine(qb, qc, qd, qx, qy, qz,
                                    pixdim[1], pixdim[2], pixdim[3],
                                    pixdim[0])
    else:
        affine = np.diag([pixdim[1] or 1.0, pixdim[2] or 1.0,
                          pixdim[3] or 1.0, 1.0])

    spacing = tuple(float(np.linalg.norm(affine[:3, i])) for i in range(3))
    return NiftiImage(data=np.asarray(data), affine=affine, spacing=spacing)


def _load_nifti2(raw: bytes) -> NiftiImage:
    endian = "<" if struct.unpack_from("<i", raw, 0)[0] == 540 else ">"
    u = lambda fmt, off: struct.unpack_from(endian + fmt, raw, off)  # noqa
    datatype = u("h", 12)[0]
    if datatype not in _DTYPES:
        raise ValueError(f"unsupported NIfTI datatype {datatype}")
    dim = u("8q", 16)
    ndim = dim[0]
    if not 1 <= ndim <= 7:
        raise ValueError(f"bad NIfTI dim[0]={ndim} (must be 1..7)")
    shape = tuple(int(x) for x in dim[1:1 + ndim])
    if any(s < 1 for s in shape):
        raise ValueError(f"bad NIfTI shape {shape}")
    pixdim = u("8d", 104)
    vox_offset = u("q", 168)[0]
    if not 540 <= vox_offset <= len(raw):
        raise ValueError(f"bad NIfTI-2 vox_offset {vox_offset}")
    scl_slope, scl_inter = u("d", 176)[0], u("d", 184)[0]
    qform_code, sform_code = u("i", 344)[0], u("i", 348)[0]
    qb, qc, qd = u("3d", 352)
    qx, qy, qz = u("3d", 376)
    srow = np.array([u("4d", 400), u("4d", 432), u("4d", 464)])

    dt = np.dtype(_DTYPES[datatype]).newbyteorder(endian)
    data = np.frombuffer(raw, dtype=dt, count=int(np.prod(shape)),
                         offset=int(vox_offset)).reshape(shape, order="F")
    # NIfTI spec: scl_slope == 0 means "no scaling" — ignore BOTH fields
    # (nibabel behavior); non-finite values are uninitialized header bytes
    # (a NaN slope would silently turn the whole volume into NaN)
    if (np.isfinite(scl_slope) and np.isfinite(scl_inter)
            and scl_slope != 0.0
            and (scl_slope != 1.0 or scl_inter != 0.0)):
        data = data.astype(np.float32) * scl_slope + scl_inter
    if sform_code > 0:
        affine = np.eye(4)
        affine[:3] = srow
    elif qform_code > 0:
        affine = _quaternion_affine(qb, qc, qd, qx, qy, qz,
                                    pixdim[1], pixdim[2], pixdim[3],
                                    pixdim[0])
    else:
        affine = np.diag([pixdim[1] or 1.0, pixdim[2] or 1.0,
                          pixdim[3] or 1.0, 1.0])
    spacing = tuple(float(np.linalg.norm(affine[:3, i])) for i in range(3))
    return NiftiImage(data=np.asarray(data), affine=affine, spacing=spacing)


def save_nifti(path: Union[str, Path], data: np.ndarray,
               affine: np.ndarray | None = None) -> None:
    """Minimal NIfTI-1 writer (float32/int16), used by the dummy-data
    generator and tests (the reference fabricates NIfTIs via nibabel in
    scripts/preprocess/create_dummy_data.py)."""
    path = Path(path)
    data = np.asarray(data)
    if affine is None:
        affine = np.eye(4)
    if data.dtype == np.float64:
        data = data.astype(np.float32)
    dt_code = {np.dtype(np.float32): 16, np.dtype(np.int16): 4,
               np.dtype(np.uint8): 2, np.dtype(np.int32): 8}[data.dtype]

    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)
    dims = [data.ndim] + list(data.shape) + [1] * (7 - data.ndim)
    struct.pack_into("<8h", hdr, 40, *dims)
    struct.pack_into("<h", hdr, 70, dt_code)
    struct.pack_into("<h", hdr, 72, data.dtype.itemsize * 8)
    spacing = [float(np.linalg.norm(affine[:3, i])) for i in range(3)]
    struct.pack_into("<8f", hdr, 76, 1.0, *spacing, 1.0, 1.0, 1.0, 1.0)
    struct.pack_into("<f", hdr, 108, 352.0)          # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)            # scl_slope
    struct.pack_into("<h", hdr, 252, 0)              # qform_code
    struct.pack_into("<h", hdr, 254, 1)              # sform_code
    struct.pack_into("<4f", hdr, 280, *affine[0])
    struct.pack_into("<4f", hdr, 296, *affine[1])
    struct.pack_into("<4f", hdr, 312, *affine[2])
    hdr[344:348] = b"n+1\x00"

    payload = bytes(hdr) + b"\x00" * 4 + np.asfortranarray(data).tobytes("F")
    if str(path).endswith(".gz"):
        path.write_bytes(gzip.compress(payload, compresslevel=1))
    else:
        path.write_bytes(payload)
