"""PNG encoding and decoding for the serving front end, with the standard
library's ``zlib`` and ``struct`` and numpy: no PIL.

The JAX server encodes every text-to-image answer and decodes every
understanding request through PIL; the machine with the card has no PIL, so
the port carries its own codec for the PNGs it writes and the common ones it
is sent:

- ``encode_png``: uint8 (H, W, 3) -> an 8-bit RGB PNG (every row filtered
  with Sub, one IDAT chunk);
- ``decode_png``: 8-bit, non-interlaced PNGs of colour types 0 (grey), 2
  (RGB), 3 (palette), 4 (grey + alpha) and 6 (RGBA), with all five filter
  types, to uint8 (H, W, 3) as PIL's ``.convert("RGB")`` gives it: alpha
  dropped, grey replicated, the palette looked up. Any other image (JPEG,
  16-bit or sub-byte depths, interlaced) is decoded through PIL where PIL is
  installed; where it is not, the error names what is missing.

``decode_png`` reads images sent over the network, so it bounds what they
may cost: an image of more than ``MAX_IMAGE_PIXELS`` pixels (PIL's own
limit) is refused before anything is inflated, and the pixel data is
inflated to no more bytes than the header's size calls for.
"""

from __future__ import annotations

import io
import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
MAX_IMAGE_PIXELS = 89_478_485  # PIL.Image.MAX_IMAGE_PIXELS
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # samples a pixel, by colour type


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """uint8 (H, W, 3) -> the bytes of an 8-bit RGB PNG."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"encode_png takes uint8 (H, W, 3), got {img.dtype} {img.shape}")
    H, W, _ = img.shape
    rows = img.reshape(H, W * 3)
    filtered = np.empty((H, 1 + W * 3), np.uint8)
    filtered[:, 0] = 1  # Sub: each byte minus the byte one pixel to its left
    filtered[:, 1:4] = rows[:, :3]
    filtered[:, 4:] = rows[:, 3:] - rows[:, :-3]  # uint8 arithmetic wraps mod 256
    header = struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(filtered.tobytes(), 6)) + _chunk(b"IEND", b""))


def _chunks(data: bytes):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        (length,), kind = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length or pos + 12 + length > len(data):
            raise ValueError(f"PNG chunk {kind!r} is cut short")
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG ends before its IEND chunk")


def _unfilter(raw: np.ndarray, H: int, W: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters of (H, 1 + W * bpp) bytes: (H, W, bpp) uint8.

    A byte's predictor reads its left, upper and upper-left neighbours (one
    pixel away), so the pixels are reconstructed one anti-diagonal at a time
    (H + W - 1 steps, each over every pixel of the diagonal at once), each
    pixel by its own row's filter. The image is held in uint8 (sums wrap mod
    256 as the filters want); only a diagonal is widened."""
    kinds = raw[:, 0]
    if kinds.max(initial=0) > 4:
        raise ValueError(f"unknown PNG filter type {int(kinds.max())}")
    d = raw[:, 1:].reshape(H, W, bpp)
    rec = np.zeros((H + 1, W + 1, bpp), np.uint8)  # a zero row above and column to the left
    if not np.isin(kinds, (3, 4)).any():
        for r in range(H):  # None, Sub, Up: a row at once
            row = d[r]
            if kinds[r] == 1:
                row = np.cumsum(row, axis=0, dtype=np.uint8)
            elif kinds[r] == 2:
                row = row + rec[r, 1:]
            rec[r + 1, 1:] = row
        return np.ascontiguousarray(rec[1:, 1:])
    for k in range(H + W - 1):
        r = np.arange(max(0, k - W + 1), min(H, k + 1))
        c = k - r
        # left, up, upper-left
        a, b, u = (x.astype(np.int16) for x in (rec[r + 1, c], rec[r, c + 1], rec[r, c]))
        p = a + b - u
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - u)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, u))
        kind = kinds[r][:, None]
        pred = np.select([kind == 1, kind == 2, kind == 3, kind == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        rec[r + 1, c + 1] = (d[r, c] + pred) & 0xFF
    return np.ascontiguousarray(rec[1:, 1:])


def _decode_with_pil(data: bytes, why: str) -> np.ndarray:
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"{why}: this image needs PIL, which is not installed; send an 8-bit, "
            "non-interlaced PNG (colour type 0, 2, 3, 4 or 6) or install Pillow") from e
    with Image.open(io.BytesIO(data)) as img:
        return np.asarray(img.convert("RGB"), np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """The image in ``data`` as uint8 (H, W, 3), as PIL's ``.convert("RGB")``
    gives it. 8-bit non-interlaced PNGs are decoded here; anything else
    through PIL."""
    if not data.startswith(SIGNATURE):
        return _decode_with_pil(data, "not a PNG")
    ihdr, idat, palette = None, [], None
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if ihdr is None:
        raise ValueError("PNG without an IHDR chunk")
    W, H, depth, ctype, _, _, interlace = ihdr
    if depth != 8 or interlace != 0 or ctype not in _CHANNELS:
        return _decode_with_pil(
            data, f"a PNG of bit depth {depth}, colour type {ctype}, interlace {interlace}")
    if W * H > MAX_IMAGE_PIXELS:
        raise ValueError(f"PNG of {W} x {H} pixels is above the limit of {MAX_IMAGE_PIXELS}")
    bpp = _CHANNELS[ctype]
    size = H * (1 + W * bpp)
    # inflated to one byte past the size at most: more is refused, not inflated
    raw = np.frombuffer(zlib.decompressobj().decompress(b"".join(idat), size + 1), np.uint8)
    if raw.size > size:
        raise ValueError(f"PNG data inflates past the {size} bytes its header calls for")
    if raw.size != size:
        raise ValueError(f"PNG data holds {raw.size} bytes, expected {size}")
    px = _unfilter(raw.reshape(H, 1 + W * bpp), H, W, bpp)
    if ctype == 2:
        return px
    if ctype == 6:
        return np.ascontiguousarray(px[..., :3])
    if ctype == 3:
        if palette is None:
            raise ValueError("palette PNG without a PLTE chunk")
        full = np.zeros((256, 3), np.uint8)  # indices past the palette read black, as PIL
        full[: len(palette)] = palette
        return full[px[..., 0]]
    return np.repeat(px[..., :1], 3, axis=2)  # grey (0) and grey + alpha (4)
