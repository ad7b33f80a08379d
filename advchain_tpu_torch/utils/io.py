"""Medical image I/O: NRRD / NIfTI loading + the reference's crop/rescale
(port of advchain_tpu/utils/io.py; the readers are pure Python and numpy).

``load_image_label`` is API-parity with reference common/utils.py:29-80
(slice select, center crop, global min-max rescale to [0, 1]) and returns
numpy arrays.  Readers prefer SimpleITK when installed; otherwise minimal
pure-numpy NRRD and NIfTI-1 parsers are used, returning arrays in the same
(z, y, x) axis order as ``sitk.GetArrayFromImage``.
"""

from __future__ import annotations

import gzip
import os
import struct
from pathlib import Path

import numpy as np

__all__ = ["check_dir", "load_image_label", "rescale_intensity",
           "read_nrrd", "read_nifti", "read_medical_image"]


def check_dir(dir_path, create: bool = False) -> int:
    """1 if exists else -1; optionally create (reference utils.py:13-26)."""
    if os.path.exists(dir_path):
        return 1
    if create:
        os.makedirs(dir_path)
    return -1


_NRRD_DTYPES = {
    "signed char": np.int8, "int8": np.int8, "int8_t": np.int8,
    "uchar": np.uint8, "unsigned char": np.uint8, "uint8": np.uint8,
    "uint8_t": np.uint8,
    "short": np.int16, "short int": np.int16, "signed short": np.int16,
    "int16": np.int16, "int16_t": np.int16,
    "ushort": np.uint16, "unsigned short": np.uint16, "uint16": np.uint16,
    "uint16_t": np.uint16,
    "int": np.int32, "signed int": np.int32, "int32": np.int32,
    "int32_t": np.int32,
    "uint": np.uint32, "unsigned int": np.uint32, "uint32": np.uint32,
    "uint32_t": np.uint32,
    "longlong": np.int64, "long long": np.int64, "int64": np.int64,
    "int64_t": np.int64,
    "ulonglong": np.uint64, "uint64": np.uint64, "uint64_t": np.uint64,
    "float": np.float32, "double": np.float64,
}


def read_nrrd(path):
    """Minimal NRRD reader (raw / gzip encodings, attached data).

    Returns the array with axes REVERSED relative to the header ``sizes``
    (fastest axis last) — matching ``sitk.GetArrayFromImage``.
    """
    with open(path, "rb") as f:
        magic = f.readline()
        if not magic.startswith(b"NRRD"):
            raise ValueError(f"{path} is not a NRRD file")
        fields = {}
        while True:
            line = f.readline()
            if line in (b"\n", b"\r\n", b""):
                break
            if line.startswith(b"#"):
                continue
            text = line.decode("ascii", "replace").strip()
            if ":" not in text:
                continue
            key, _, val = text.partition(":")
            fields[key.strip().lower()] = val.lstrip("=").strip()
        data = f.read()

    dtype = _NRRD_DTYPES[fields["type"]]
    sizes = [int(s) for s in fields["sizes"].split()]
    encoding = fields.get("encoding", "raw").lower()
    if encoding in ("gzip", "gz"):
        data = gzip.decompress(data)
    elif encoding != "raw":
        raise NotImplementedError(f"NRRD encoding {encoding!r}")
    endian = fields.get("endian", "little")
    dt = np.dtype(dtype).newbyteorder("<" if endian == "little" else ">")
    count = int(np.prod(sizes))
    arr = np.frombuffer(data[:count * dt.itemsize], dtype=dt)
    return arr.reshape(sizes[::-1])  # sitk axis order (z, y, x)


def read_nifti(path):
    """Minimal NIfTI-1 reader (.nii / .nii.gz), returning (z, y, x[,...])
    like ``sitk.GetArrayFromImage`` (reversed dim order)."""
    raw = Path(path).read_bytes()
    if str(path).endswith(".gz") or raw[:2] == b"\x1f\x8b":
        raw = gzip.decompress(raw)
    hdr = raw[:348]
    sizeof_hdr = struct.unpack("<i", hdr[0:4])[0]
    endian = "<"
    if sizeof_hdr != 348:
        endian = ">"
        sizeof_hdr = struct.unpack(">i", hdr[0:4])[0]
        assert sizeof_hdr == 348, "not a NIfTI-1 file"
    dim = struct.unpack(endian + "8h", hdr[40:56])
    ndim = dim[0]
    shape = dim[1:1 + ndim]
    datatype = struct.unpack(endian + "h", hdr[70:72])[0]
    vox_offset = int(struct.unpack(endian + "f", hdr[108:112])[0])
    scl_slope = struct.unpack(endian + "f", hdr[112:116])[0]
    scl_inter = struct.unpack(endian + "f", hdr[116:120])[0]
    dtypes = {2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32,
              64: np.float64, 256: np.int8, 512: np.uint16, 768: np.uint32}
    if datatype not in dtypes:
        raise NotImplementedError(f"NIfTI datatype {datatype}")
    dt = np.dtype(dtypes[datatype]).newbyteorder(endian)
    count = int(np.prod(shape))
    arr = np.frombuffer(raw[vox_offset:vox_offset + count * dt.itemsize],
                        dtype=dt)
    arr = arr.reshape(shape, order="F")  # NIfTI is Fortran-ordered (x,y,z)
    arr = np.transpose(arr, tuple(range(arr.ndim))[::-1])  # -> (z, y, x)
    # NIfTI scaling: slope==0 means "no scaling stored"; otherwise apply
    # slope/intercept whenever they are not the identity pair
    if scl_slope != 0.0 and (scl_slope != 1.0 or scl_inter != 0.0):
        arr = arr * scl_slope + scl_inter
    return arr


def read_medical_image(path):
    """Dispatch on extension; prefers SimpleITK when available."""
    try:
        import SimpleITK as sitk  # noqa
        if hasattr(sitk, "ReadImage"):
            return sitk.GetArrayFromImage(sitk.ReadImage(str(path)))
    except ImportError:
        pass
    p = str(path)
    if p.endswith(".nrrd"):
        return read_nrrd(p)
    if p.endswith(".nii") or p.endswith(".nii.gz"):
        return read_nifti(p)
    raise NotImplementedError(f"unsupported image format: {p}")


def load_image_label(image_path, label_path=None, slice_id: int = 0,
                     crop_size=(192, 192)):
    """Load image (and optional label), slice (or whole volume with
    ``slice_id=-1``), center-crop, min-max rescale image to [0, 1]
    (reference common/utils.py:29-80)."""
    support_formats = [".nrrd", ".nii", ".nii.gz"]
    suffixes = "".join(Path(image_path).suffixes)
    assert any(suffixes.endswith(s) for s in support_formats), (
        f"only support loading images/labels with extensions:"
        f"{support_formats}.")
    image = read_medical_image(image_path)
    if slice_id >= 0:
        image = image[slice_id]
        h_ind, w_ind = 0, 1
    else:
        h_ind, w_ind = 1, 2
    h_diff = (image.shape[h_ind] - crop_size[0]) // 2
    w_diff = (image.shape[w_ind] - crop_size[1]) // 2
    if slice_id >= 0:
        cropped_image = image[h_diff:crop_size[0] + h_diff,
                              w_diff:crop_size[1] + w_diff]
    else:
        cropped_image = image[:, h_diff:crop_size[0] + h_diff,
                              w_diff:crop_size[1] + w_diff]
    cropped_image = (cropped_image - cropped_image.min()) / \
        (cropped_image.max() - cropped_image.min() + 1e-10)

    if label_path is not None:
        label = read_medical_image(label_path)
        if slice_id >= 0:
            label = label[slice_id]
        assert image.shape == label.shape, (
            f"The sizes of the input image and label do not match, "
            f"image:{image.shape} label:{label.shape}")
        if slice_id >= 0:
            cropped_label = label[h_diff:crop_size[0] + h_diff,
                                  w_diff:crop_size[1] + w_diff]
        else:
            cropped_label = label[:, h_diff:crop_size[0] + h_diff,
                                  w_diff:crop_size[1] + w_diff]
        return cropped_image, cropped_label
    return cropped_image


def rescale_intensity(data, new_min=0, new_max=1, eps=1e-20):
    """Per-(sample, channel) min-max rescale of a batched NCHW tensor on any
    device (reference common/utils.py:82-95); delegates to ops.norms."""
    from advchain_tpu_torch.ops.norms import rescale_intensity as _ri
    return _ri(data, new_min, new_max, eps, per_channel=True)
