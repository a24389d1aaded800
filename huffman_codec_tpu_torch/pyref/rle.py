"""MNP-5 byte-level RLE and adaptive block RLE — exact model of transform.cpp.

Format rules (probed empirically against the reference; see SURVEY.md §2.3):

* A run of N >= 3 equal bytes is emitted as 3 literals + one count byte
  ``min(N, 258) - 3`` (transform.cpp:256-269).
* Count byte 255 (run of 258) RESETS the matcher (transform.cpp:259-263):
  longer runs restart from scratch (516 x 'A' -> AAA 255 AAA 254).
* The LAST input byte never extends a run (the ``next(it) != end`` guard,
  transform.cpp:252): a pending count is flushed and the final byte is a
  literal — 'AAAA' -> AAA 0 A. Breaking this "improves" compression and
  silently breaks size parity with the reference.
"""

from __future__ import annotations

from huffman_codec_tpu_torch.formats import (
    block_count,
    make_adapt_rle_header,
    parse_adapt_rle_header,
)

INIT_RLE_BLOCK_SIZE = 8  # transform.hpp:17
MAX_RLE_DOUBLING_STEPS = 7  # transform.hpp:18


def rle_encode(data) -> bytearray:
    """Exact model of applyRLE (transform.cpp:241-279)."""
    out = bytearray()
    match_byte = 0
    match_count = 0
    last = len(data) - 1
    for i, b in enumerate(data):
        if b == match_byte and match_count != 0 and i != last:
            match_count += 1
            if match_count <= 3:
                out.append(b)
            elif match_count == 258:  # 255 + 3 -> emit max count, reset
                out.append(255)
                match_count = 0
        else:
            if match_count >= 3:
                out.append(match_count - 3)
            out.append(b)
            match_byte = b
            match_count = 1
    return out


def rle_decode(data, out: bytearray | None = None, start: int = 0,
               limit: int | None = None) -> tuple[bytearray, int]:
    """Exact model of revertRLE / revertRLEStep (transform.cpp:137-159, 281-292).

    Decodes from ``data[start:]`` into ``out`` until input is exhausted or
    ``limit`` output bytes are produced (block mode, transform.cpp:162-187).
    Returns (out, next input position).
    """
    if out is None:
        out = bytearray()
    base = len(out)
    match_byte = 0
    match_count = 0
    pos = start
    n = len(data)
    while pos < n:
        if limit is not None and len(out) - base >= limit:
            break
        cur = data[pos]
        pos += 1
        if match_count == 3:
            out.extend(bytes([match_byte]) * cur)
            match_count = 0
        else:
            out.append(cur)
            if match_byte == cur:
                match_count += 1
            else:
                match_byte = cur
                match_count = 1
    return out, pos


# ---------------------------------------------------------------------------
# adaptive block RLE (transform.cpp:25-134, 294-361)
# ---------------------------------------------------------------------------


def _block_geometry(width: int, height: int, block_size: int, index: int):
    """Tile index -> (base, size_x, size_y) with border clamping
    (transform.cpp:25-62)."""
    blocks_in_line = (width + block_size - 1) // block_size
    base_x = (index % blocks_in_line) * block_size
    base_y = (index // blocks_in_line) * block_size
    size_x = min(block_size, width - base_x)
    size_y = min(block_size, height - base_y)
    return base_y * width + base_x, size_x, size_y


def _gather_block(matrix, width, base, size_x, size_y, horizontal: bool):
    """One tile in row-major (horizontal) or transposed order
    (transform.cpp:66-94; extents swap for vertical scans)."""
    out = bytearray()
    if horizontal:
        for y in range(size_y):
            row = base + y * width
            out += matrix[row : row + size_x]
    else:
        for x in range(size_x):
            for y in range(size_y):
                out.append(matrix[base + y * width + x])
    return out


def _scatter_block(matrix, block, width, base, size_x, size_y, horizontal: bool):
    """Inverse of _gather_block (transform.cpp:191-216)."""
    idx = 0
    if horizontal:
        for y in range(size_y):
            row = base + y * width
            matrix[row : row + size_x] = block[idx : idx + size_x]
            idx += size_x
    else:
        for x in range(size_x):
            for y in range(size_y):
                matrix[base + y * width + x] = block[idx]
                idx += 1


def adapt_rle_encode_fixed(matrix, width: int, height: int, block_size: int) -> bytes:
    """Adaptive block RLE at one block size: per tile, RLE both scan orders,
    keep the smaller (horizontal wins ties -> dir bit 1, transform.cpp:114-123);
    output = AdaptRLEHeader ++ concatenated winning tile streams
    (transform.cpp:97-134)."""
    dirs: list[bool] = []
    blocks = bytearray()
    for i in range(block_count(width, height, block_size)):
        base, sx, sy = _block_geometry(width, height, block_size, i)
        hor = rle_encode(_gather_block(matrix, width, base, sx, sy, True))
        ver = rle_encode(_gather_block(matrix, width, base, sx, sy, False))
        if len(hor) <= len(ver):
            dirs.append(True)
            blocks += hor
        else:
            dirs.append(False)
            blocks += ver
    return make_adapt_rle_header(width, height, block_size, dirs) + bytes(blocks)


def adapt_rle_encode(matrix, width: int, height: int) -> bytes:
    """Auto block-size search: bs = 8, 16, ... doubling at most 7 times while
    bs <= min(W, H); strictly-smaller output wins, so ties keep the SMALLER
    block size (transform.cpp:294-328, the ``<`` at transform.cpp:319)."""
    bs = INIT_RLE_BLOCK_SIZE
    if width < bs or height < bs:
        raise ValueError("too small 2D data dimensions")  # exit 12
    best = adapt_rle_encode_fixed(matrix, width, height, bs)
    bs *= 2
    steps = 1
    while steps <= MAX_RLE_DOUBLING_STEPS and bs <= width and bs <= height:
        cur = adapt_rle_encode_fixed(matrix, width, height, bs)
        if len(cur) < len(best):
            best = cur
        bs *= 2
        steps += 1
    return best


def adapt_rle_decode(data) -> bytearray:
    """Exact model of revertAdaptRLE (transform.cpp:330-361)."""
    width, height, block_size, dirs, pos = parse_adapt_rle_header(bytes(data))
    matrix = bytearray(width * height)
    for i in range(block_count(width, height, block_size)):
        base, sx, sy = _block_geometry(width, height, block_size, i)
        block = bytearray()
        block, pos = rle_decode(data, block, pos, limit=sx * sy)
        if len(block) < sx * sy:
            raise ValueError("unexpected end of adaptive block RLE data")  # exit 14
        if len(block) != sx * sy:
            raise ValueError("invalid adaptive block RLE file contents")  # exit 13
        _scatter_block(matrix, block, width, base, sx, sy, dirs[i])
    if pos != len(data):
        raise ValueError("leftover data of adaptive block RLE detected")  # exit 15
    return matrix
