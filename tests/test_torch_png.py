"""``serve/png.py``, the port's PNG codec: PIL reads what it writes bit for
bit; it reads what PIL writes as PIL's ``.convert("RGB")`` does, for every
colour type and filter it decodes itself; every other image goes through
PIL, or raises where PIL is missing; the server's resize stays within two
levels of PIL's."""

import io
import struct
import sys
import zlib

import numpy as np
import pytest
from PIL import Image

from omnimamba_tpu_torch.serve.png import (
    MAX_IMAGE_PIXELS, SIGNATURE, _chunk, decode_png, encode_png)


def rgb(seed, h, w):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


def smooth(h, w):
    """Gradients, on which PIL's adaptive filtering picks Average and Paeth."""
    y, x = np.mgrid[0:h, 0:w]
    return np.stack([(3 * x + y) % 256, (5 * y) % 256, (x * y // 7) % 256], -1).astype(np.uint8)


def pil_png(img, mode, optimize):
    im = Image.fromarray(img)
    if mode == "P":
        im = im.quantize(200)  # more than 16 colours: 8-bit indices
    elif mode == "RGBA":
        alpha = (np.arange(img.shape[0] * img.shape[1]) % 251).reshape(img.shape[:2], order="F")
        im = Image.fromarray(np.concatenate([img, alpha[..., None].astype(np.uint8)], -1), "RGBA")
    elif mode != "RGB":
        im = im.convert(mode)
    buf = io.BytesIO()
    im.save(buf, format="PNG", optimize=optimize)
    return buf.getvalue()


def pil_rgb(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def filter_types(data):
    """The filter byte of every row of an 8-bit, non-interlaced PNG."""
    w, h, _, ctype = struct.unpack(">IIBB", data[16:26])
    bpp = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    pos, idat = 8, b""
    while pos < len(data):
        (n,), kind = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:pos + 8]
        idat += data[pos + 8:pos + 8 + n] if kind == b"IDAT" else b""
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * bpp)
    return set(raw[:, 0].tolist())


@pytest.mark.parametrize("shape", [(1, 1), (37, 53), (64, 48), (3, 200)])
def test_pil_reads_encode_png_exactly(shape):
    img = rgb(sum(shape), *shape)
    data = encode_png(img)
    with Image.open(io.BytesIO(data)) as im:
        assert im.mode == "RGB" and im.size == (shape[1], shape[0])
        np.testing.assert_array_equal(np.asarray(im), img)
    np.testing.assert_array_equal(decode_png(data), img)


@pytest.mark.parametrize("optimize", [False, True])
@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA", "P"])
def test_decode_equals_pil_convert_rgb(mode, optimize):
    used = set()
    for img in (rgb(1, 29, 41), smooth(61, 47)):
        data = pil_png(img, mode, optimize)
        assert data[24] == 8 and data[28] == 0  # 8-bit, not interlaced: decoded here
        got = decode_png(data)
        assert got.dtype == np.uint8 and got.shape == img.shape
        np.testing.assert_array_equal(got, pil_rgb(data))
        used |= filter_types(data)
    if mode != "P":  # PIL's adaptive filters on a gradient take Paeth (every type: below)
        assert 4 in used, used


def _filtered_png(img, kinds):
    """An RGB or grey PNG whose row r is filtered with kinds[r], the filters
    written out byte by byte (PNG spec, section 9)."""
    h, w, c = img.shape
    px = img.reshape(h, w * c).astype(int)
    rows = []
    for r in range(h):
        out = [kinds[r]]
        for i in range(w * c):
            a = px[r, i - c] if i >= c else 0
            b = px[r - 1, i] if r else 0
            u = px[r - 1, i - c] if r and i >= c else 0
            p = a + b - u
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - u)
            paeth = a if pa <= pb and pa <= pc else b if pb <= pc else u
            pred = [0, a, b, (a + b) // 2, paeth][kinds[r]]
            out.append((px[r, i] - pred) % 256)
        rows.append(bytes(out))
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    header = struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", header) + _chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + _chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("kinds", ["each", "none_sub_up"])
def test_every_filter_type(channels, kinds):
    img = np.random.default_rng(channels).integers(0, 256, (11, 9, channels), dtype=np.uint8)
    row_kinds = [r % 5 for r in range(11)] if kinds == "each" else [r % 3 for r in range(11)]
    data = _filtered_png(img, row_kinds)
    np.testing.assert_array_equal(decode_png(data), pil_rgb(data))


@pytest.mark.parametrize("fmt", ["jpeg", "png_16_bit", "png_4_bit_palette"])
def test_other_images_go_through_pil(fmt, monkeypatch):
    img = smooth(20, 30)
    buf = io.BytesIO()
    if fmt == "jpeg":
        Image.fromarray(img).save(buf, format="JPEG")
    elif fmt == "png_16_bit":
        Image.fromarray((img[..., 0].astype(np.uint16) * 257)).save(buf, format="PNG")
    else:
        Image.fromarray(img).quantize(12).save(buf, format="PNG")
    data = buf.getvalue()
    np.testing.assert_array_equal(decode_png(data), pil_rgb(data))
    monkeypatch.setitem(sys.modules, "PIL", None)  # as on a machine without PIL
    with pytest.raises(ImportError, match="needs PIL"):
        decode_png(data)
    assert decode_png(encode_png(img)).shape == img.shape  # its own PNGs still decode


def test_interlaced_png_needs_pil(monkeypatch):
    """PIL writes no interlaced PNG: an IHDR that says Adam7 is enough to
    take the PIL route, which names what is missing."""
    data = encode_png(rgb(2, 6, 6))
    header = struct.pack(">IIBBBBB", 6, 6, 8, 2, 0, 0, 1)
    data = data[:8] + _chunk(b"IHDR", header) + data[33:]
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="interlace 1"):
        decode_png(data)


def test_damaged_pngs_raise():
    data = bytearray(encode_png(rgb(0, 8, 8)))
    data[40] ^= 0xFF  # inside the IDAT chunk
    with pytest.raises(ValueError, match="CRC"):
        decode_png(bytes(data))
    with pytest.raises(ValueError, match="IEND"):
        decode_png(encode_png(rgb(0, 8, 8))[:-12])


def png_of(w, h, idat):
    """An 8-bit RGB PNG whose IHDR says w x h, with ``idat`` as its IDAT."""
    return (SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", idat) + _chunk(b"IEND", b""))


def test_decompression_bomb_is_not_inflated():
    """64 MiB of zeros behind an 8 x 8 header: the data is inflated to one
    byte past the 200 the header calls for, and refused."""
    bomb = png_of(8, 8, zlib.compress(bytes(64 << 20), 9))
    assert len(bomb) < 100_000
    with pytest.raises(ValueError, match="inflates past the 200 bytes"):
        decode_png(bomb)
    # the same header over exactly its 200 bytes decodes
    assert decode_png(png_of(8, 8, zlib.compress(bytes(200)))).shape == (8, 8, 3)


@pytest.mark.parametrize("wh", [(20_000, 20_000), (MAX_IMAGE_PIXELS + 1, 1)])
def test_oversized_header_is_refused_before_inflating(wh):
    """A header above PIL's pixel limit is refused before its data is
    looked at (here one that would inflate to many GiB of zeros)."""
    with pytest.raises(ValueError, match="above the limit of 89478485"):
        decode_png(png_of(*wh, zlib.compress(bytes(1 << 20))))


@pytest.mark.parametrize("size", [(40, 70), (100, 80), (56, 56)])
def test_server_resize_within_two_levels_of_pil(size):
    """``OmniMambaService.load_image``: PIL's ``img.resize((side, side))``
    within two levels; at the towers' size the pixels as they came."""
    import base64
    import types

    from omnimamba_tpu_torch.serve.server import OmniMambaService

    img = smooth(*size)
    stub = types.SimpleNamespace(model=types.SimpleNamespace(
        vision_cfg=types.SimpleNamespace(dino=types.SimpleNamespace(img_size=56))))
    got = OmniMambaService.load_image(stub, base64.b64encode(encode_png(img)))
    want = np.asarray(Image.fromarray(img).resize((56, 56)))
    assert got.shape == (56, 56, 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 2
    if size == (56, 56):
        np.testing.assert_array_equal(got, img)
