"""Minimal self-contained NIfTI-1 reader/writer (pure NumPy).

Replaces the reference's vendored niftilib/znzlib/zlib
(IRTKSimple2/nifti, ~35k LoC of C) with ~200 lines of NumPy.  Supports
.nii / .nii.gz, int/float datatypes, scl_slope/inter scaling, and both
qform (quaternion) and sform affines per the NIfTI-1 spec.

A copy of fetalreconstruction_tpu/io/nifti1.py: host code in numpy, with
the same results; it imports only from this package.
"""
from __future__ import annotations

import gzip
import struct
from dataclasses import dataclass, field

import numpy as np

from .. import native

_HDR_SIZE = 348

# NIfTI-1 datatype codes -> numpy dtypes
_DTYPES = {
    2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32, 64: np.float64,
    256: np.int8, 512: np.uint16, 768: np.uint32, 1024: np.int64,
    1280: np.uint64,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


@dataclass
class Nifti1Header:
    dim: np.ndarray = field(default_factory=lambda: np.ones(8, np.int16))
    pixdim: np.ndarray = field(default_factory=lambda: np.ones(8, np.float32))
    datatype: int = 16
    scl_slope: float = 1.0
    scl_inter: float = 0.0
    qform_code: int = 0
    sform_code: int = 0
    quatern: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    qoffset: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    srow: np.ndarray = field(default_factory=lambda: np.zeros((3, 4), np.float32))
    vox_offset: float = 352.0
    toffset: float = 0.0
    xyzt_units: int = 10  # mm | sec

    def qform(self) -> np.ndarray:
        """Quaternion qform -> 4x4 affine (nifti1 spec method 2)."""
        b, c, d = [float(q) for q in self.quatern]
        a2 = 1.0 - (b * b + c * c + d * d)
        a = np.sqrt(max(a2, 0.0))
        r = np.array([
            [a * a + b * b - c * c - d * d, 2 * b * c - 2 * a * d,
             2 * b * d + 2 * a * c],
            [2 * b * c + 2 * a * d, a * a + c * c - b * b - d * d,
             2 * c * d - 2 * a * b],
            [2 * b * d - 2 * a * c, 2 * c * d + 2 * a * b,
             a * a + d * d - c * c - b * b]])
        qfac = float(self.pixdim[0])
        if qfac == 0:
            qfac = 1.0
        sp = np.abs(self.pixdim[1:4]).astype(np.float64)
        affine = np.eye(4)
        affine[:3, :3] = r * sp[None, :] * np.array([1.0, 1.0, qfac])
        affine[:3, 3] = self.qoffset
        return affine

    def sform(self) -> np.ndarray:
        affine = np.eye(4)
        affine[:3, :] = self.srow
        return affine


def _parse_header(raw: bytes):
    """Parse the 348-byte header; returns (header, endianness prefix).

    Endianness is detected from sizeof_hdr exactly as niftilib does
    (nifti1_io.c nifti_hdr_looks_good / swap_nifti_header): if the
    little-endian read is not 348 but the byte-swapped one is, the whole
    file is big-endian (old scanner exports) and every field — and the
    voxel data — is byte-swapped on read.
    """
    if len(raw) < _HDR_SIZE:
        raise ValueError("truncated NIfTI header")
    e = "<"
    if struct.unpack("<i", raw[0:4])[0] != _HDR_SIZE:
        if struct.unpack(">i", raw[0:4])[0] == _HDR_SIZE:
            e = ">"
        else:
            raise ValueError(
                f"bad sizeof_hdr {struct.unpack('<i', raw[0:4])[0]}")
    h = Nifti1Header()
    h.dim = np.frombuffer(raw[40:56], e + "i2").copy()
    h.datatype = struct.unpack(e + "h", raw[70:72])[0]
    h.pixdim = np.frombuffer(raw[76:108], e + "f4").copy()
    h.vox_offset = struct.unpack(e + "f", raw[108:112])[0]
    h.scl_slope = struct.unpack(e + "f", raw[112:116])[0]
    h.scl_inter = struct.unpack(e + "f", raw[116:120])[0]
    h.xyzt_units = raw[123]
    h.toffset = struct.unpack(e + "f", raw[128:132])[0]
    h.qform_code = struct.unpack(e + "h", raw[252:254])[0]
    h.sform_code = struct.unpack(e + "h", raw[254:256])[0]
    h.quatern = np.frombuffer(raw[256:268], e + "f4").copy()
    h.qoffset = np.frombuffer(raw[268:280], e + "f4").copy()
    h.srow = np.frombuffer(raw[280:328], e + "f4").copy().reshape(3, 4)
    return h, e


def load(path: str):
    """Read a .nii/.nii.gz file.

    Returns (data, affine, header) with data in fortran-ish [x,y,z,(t)]
    axis order (axis 0 = x, fastest-varying in the file).
    """
    raw = native.read_bytes(path)
    if raw is None:
        opener = gzip.open if str(path).endswith(".gz") else open
        with opener(path, "rb") as f:
            raw = f.read()
    return load_bytes(raw)


def load_bytes(raw: bytes):
    """Parse an (already decompressed) NIfTI-1 byte stream."""
    h, endian = _parse_header(raw[:_HDR_SIZE])
    ndim = int(h.dim[0])
    shape = tuple(int(s) for s in h.dim[1:1 + ndim])
    if ndim > 4:
        raise ValueError(f"unsupported ndim {ndim}")
    dtype = _DTYPES.get(int(h.datatype))
    if dtype is None:
        raise ValueError(f"unsupported datatype {h.datatype}")
    offset = int(h.vox_offset)
    count = int(np.prod(shape))
    data = np.frombuffer(raw, dtype=np.dtype(dtype).newbyteorder(endian),
                         count=count, offset=offset)
    if endian == ">":
        data = data.astype(data.dtype.newbyteorder("<"))
    # file order: x fastest -> reshape with fortran order to [x,y,z,(t)]
    data = data.reshape(shape, order="F")
    slope = h.scl_slope if h.scl_slope not in (0.0,) else 1.0
    if not np.isfinite(slope):
        slope = 1.0
    inter = h.scl_inter if np.isfinite(h.scl_inter) else 0.0
    if slope != 1.0 or inter != 0.0:
        data = data.astype(np.float32) * np.float32(slope) + np.float32(inter)
    # affine preference mirrors IRTK (irtkFileNIFTIToImage.cc:257-263):
    # qform first, then sform, then pixdim-diagonal fallback.
    if h.qform_code > 0:
        affine = h.qform()
    elif h.sform_code > 0:
        affine = h.sform()
    else:
        affine = np.diag([-abs(float(h.pixdim[1])), float(abs(h.pixdim[2])),
                          float(abs(h.pixdim[3])), 1.0])
        affine[0, 3] = abs(float(h.pixdim[1])) * (shape[0] - 1) / 2.0
        affine[1, 3] = -abs(float(h.pixdim[2])) * (shape[1] - 1) / 2.0
        affine[2, 3] = -abs(float(h.pixdim[3])) * (shape[2] - 1) / 2.0
    return data, affine, h


def _mat_to_quatern(affine: np.ndarray):
    """Affine -> (quatern_bcd, qfac) per nifti1 spec (nifti_mat44_to_quatern)."""
    r = affine[:3, :3].astype(np.float64).copy()
    sp = np.linalg.norm(r, axis=0)
    sp[sp == 0] = 1.0
    r = r / sp[None, :]
    qfac = 1.0
    if np.linalg.det(r) < 0:
        r[:, 2] *= -1
        qfac = -1.0
    # orthonormalize lightly (fetal data affines are rigid*diag already)
    u, _, vt = np.linalg.svd(r)
    r = u @ vt
    tr = np.trace(r)
    if tr > 0:
        s = np.sqrt(tr + 1.0)
        a = 0.5 * s
        s = 0.5 / s
        b = (r[2, 1] - r[1, 2]) * s
        c = (r[0, 2] - r[2, 0]) * s
        d = (r[1, 0] - r[0, 1]) * s
    else:
        xd = 1.0 + r[0, 0] - r[1, 1] - r[2, 2]
        yd = 1.0 + r[1, 1] - r[0, 0] - r[2, 2]
        zd = 1.0 + r[2, 2] - r[0, 0] - r[1, 1]
        if xd > 1.0:
            b = 0.5 * np.sqrt(xd)
            c = 0.25 * (r[0, 1] + r[1, 0]) / b
            d = 0.25 * (r[0, 2] + r[2, 0]) / b
            a = 0.25 * (r[2, 1] - r[1, 2]) / b
        elif yd > 1.0:
            c = 0.5 * np.sqrt(yd)
            b = 0.25 * (r[0, 1] + r[1, 0]) / c
            d = 0.25 * (r[1, 2] + r[2, 1]) / c
            a = 0.25 * (r[0, 2] - r[2, 0]) / c
        else:
            d = 0.5 * np.sqrt(zd)
            b = 0.25 * (r[0, 2] + r[2, 0]) / d
            c = 0.25 * (r[1, 2] + r[2, 1]) / d
            a = 0.25 * (r[1, 0] - r[0, 1]) / d
        if a < 0.0:
            a, b, c, d = -a, -b, -c, -d
    return np.array([b, c, d], dtype=np.float32), qfac


def save(path: str, data: np.ndarray, affine: np.ndarray) -> None:
    """Write data ([x,y,z,(t)] axis order) with the given 4x4 affine."""
    data = np.asarray(data)
    if data.dtype not in _DTYPE_CODES:
        data = data.astype(np.float32)
    ndim = data.ndim
    if ndim not in (3, 4):
        raise ValueError(f"unsupported ndim {ndim}")
    dim = np.ones(8, np.int16)
    dim[0] = ndim
    dim[1:1 + ndim] = data.shape
    sp = np.linalg.norm(affine[:3, :3], axis=0)
    sp[sp == 0] = 1.0
    quatern, qfac = _mat_to_quatern(affine)
    pixdim = np.ones(8, np.float32)
    pixdim[0] = qfac
    pixdim[1:4] = sp

    hdr = bytearray(_HDR_SIZE)
    struct.pack_into("<i", hdr, 0, _HDR_SIZE)
    hdr[39] = ord("r")  # dim_info unused; regular
    hdr[40:56] = dim.astype("<i2").tobytes()
    struct.pack_into("<h", hdr, 70, _DTYPE_CODES[np.dtype(data.dtype)])
    struct.pack_into("<h", hdr, 72, data.dtype.itemsize * 8)  # bitpix
    hdr[76:108] = pixdim.astype("<f4").tobytes()
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)    # scl_slope
    struct.pack_into("<f", hdr, 116, 0.0)    # scl_inter
    hdr[123] = 10  # xyzt_units: mm + sec
    struct.pack_into("<h", hdr, 252, 1)  # qform_code
    struct.pack_into("<h", hdr, 254, 1)  # sform_code
    hdr[256:268] = quatern.astype("<f4").tobytes()
    hdr[268:280] = affine[:3, 3].astype("<f4").tobytes()
    hdr[280:328] = affine[:3, :].astype("<f4").tobytes()
    hdr[344:348] = b"n+1\x00"
    payload = bytes(hdr) + b"\x00" * 4 + np.asfortranarray(data).tobytes(order="F")
    gz = str(path).endswith(".gz")
    if native.write_bytes(path, payload, gzip_frame=gz):
        return
    opener = gzip.open if gz else open
    with opener(path, "wb") as f:
        f.write(payload)
