"""Spec-compliant FLAC encoder (verbatim/constant subframes).

The write-side complement of ``native/flac_decoder.cpp``: where the
reference shells out to sox for every FLAC<->wav conversion
(reference data/librispeech.py:45), this repo decodes AND encodes FLAC
in-tree.  The encoder emits the mandatory subset of the format —
STREAMINFO with a real MD5 signature, fixed-blocksize frames with
UTF-8-coded frame numbers, verbatim subframes (constant subframes where
a block is flat), and genuine CRC-8 / CRC-16 checksums — so the output
is readable by any conforming decoder, not only ours.

A copy of the JAX package's ``audio/flac_encode.py``.

Compression is intentionally not attempted: verbatim streams are
bit-exact, dead simple to verify, and dataset-prep speed here is
dominated by resampling, not IO.
"""

from __future__ import annotations

import hashlib

import numpy as np

__all__ = ["encode_flac", "save_flac"]


def _crc_table(poly: int, width: int) -> np.ndarray:
    top = 1 << (width - 1)
    mask = (1 << width) - 1
    table = np.zeros(256, np.uint32)
    for i in range(256):
        crc = i << (width - 8)
        for _ in range(8):
            crc = ((crc << 1) ^ poly) if (crc & top) else (crc << 1)
        table[i] = crc & mask
    return table


_CRC8_TABLE = _crc_table(0x07, 8)       # x^8 + x^2 + x + 1
_CRC16_TABLE = _crc_table(0x8005, 16)   # x^16 + x^15 + x^2 + 1


def _crc8(data: bytes) -> int:
    crc = 0
    for b in data:
        crc = int(_CRC8_TABLE[crc ^ b])
    return crc


def _crc16(data: bytes) -> int:
    crc = 0
    for b in data:
        crc = int(_CRC16_TABLE[((crc >> 8) ^ b) & 0xFF]) ^ ((crc << 8) & 0xFFFF)
    return crc


class _BitWriter:
    def __init__(self):
        self._out = bytearray()
        self._acc = 0
        self._nbits = 0

    def write(self, value: int, n: int):
        self._acc = (self._acc << n) | (value & ((1 << n) - 1))
        self._nbits += n
        while self._nbits >= 8:
            self._nbits -= 8
            self._out.append((self._acc >> self._nbits) & 0xFF)
        self._acc &= (1 << self._nbits) - 1

    def write_signed(self, value: int, n: int):
        self.write(value & ((1 << n) - 1), n)

    def write_bytes(self, data: bytes):
        assert self._nbits == 0, "write_bytes requires byte alignment"
        self._out += data

    def align(self):
        if self._nbits:
            self.write(0, 8 - self._nbits)

    def tobytes(self) -> bytes:
        assert self._nbits == 0
        return bytes(self._out)


def _utf8_code(n: int) -> bytes:
    """FLAC's UTF-8-style coded number (frame number, up to 36 bits)."""
    if n < 0x80:
        return bytes([n])
    # 110xxxxx 10xxxxxx ... : `extra` continuation bytes carry 6 bits each,
    # the lead byte carries (6 - extra) bits under `extra`+1 set bits.
    for extra in range(1, 7):
        if n < (1 << (6 * extra + (6 - extra))):
            lead_bits = 6 - extra
            head = (0xFF << (lead_bits + 1)) & 0xFF
            out = [head | (n >> (6 * extra)) & ((1 << lead_bits) - 1)]
            for i in range(extra - 1, -1, -1):
                out.append(0x80 | ((n >> (6 * i)) & 0x3F))
            return bytes(out)
    raise ValueError(f"frame number too large: {n}")


def encode_flac(samples: np.ndarray, sample_rate: int = 16000,
                bits: int = 16, block_size: int = 4096) -> bytes:
    """Encode integer PCM ``samples`` ((N,) or (N, channels)) to FLAC bytes."""
    samples = np.asarray(samples)
    if samples.ndim == 1:
        samples = samples[:, None]
    total, channels = samples.shape
    if not (1 <= channels <= 8):
        raise ValueError(f"unsupported channel count {channels}")
    if not (4 <= bits <= 32):
        raise ValueError(f"unsupported bit depth {bits}")
    if not (16 <= block_size <= 65535):
        raise ValueError(f"block_size {block_size} outside FLAC's valid "
                         "16..65535 range (RFC 9639 §8.2)")
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    s64 = samples.astype(np.int64)
    if s64.min(initial=0) < lo or s64.max(initial=0) > hi:
        raise ValueError(f"samples exceed {bits}-bit range")

    # MD5 of the unencoded audio: interleaved little-endian signed samples.
    nbytes = (bits + 7) // 8
    inter = s64.reshape(-1)
    raw = np.zeros((inter.size, nbytes), np.uint8)
    u = inter.astype(np.uint64) & ((1 << (8 * nbytes)) - 1)
    for i in range(nbytes):
        raw[:, i] = (u >> (8 * i)) & 0xFF
    md5 = hashlib.md5(raw.tobytes()).digest()

    out = bytearray(b"fLaC")
    si = _BitWriter()
    # min == max marks the stream fixed-blocksize (RFC 9639 §8.2) — which it
    # is: every frame header below declares fixed-blocksize. A shorter FINAL
    # block is explicitly allowed and does not lower the minimum.
    si.write(block_size, 16)
    si.write(block_size, 16)
    si.write(0, 24)  # min frame size unknown
    si.write(0, 24)  # max frame size unknown
    si.write(sample_rate, 20)
    si.write(channels - 1, 3)
    si.write(bits - 1, 5)
    si.write(total, 36)
    body = si.tobytes() + md5
    out += bytes([0x80]) + len(body).to_bytes(3, "big") + body  # last block

    sample_size_codes = {8: 1, 12: 2, 16: 4, 20: 5, 24: 6, 32: 7}

    for frame_no, start in enumerate(range(0, max(total, 1), block_size)):
        chunk = samples[start:start + block_size]
        bs = len(chunk)
        if bs == 0:
            break
        w = _BitWriter()
        w.write(0x3FFE, 14)
        w.write(0, 1)   # reserved
        w.write(0, 1)   # fixed-blocksize stream
        w.write(7, 4)   # block size: 16-bit value-1 follows
        w.write(0, 4)   # sample rate: from STREAMINFO
        w.write(channels - 1, 4)  # independent channels
        w.write(sample_size_codes.get(bits, 0), 3)
        w.write(0, 1)   # reserved
        w.write_bytes(_utf8_code(frame_no))
        w.write(bs - 1, 16)
        w.write(_crc8(w.tobytes()), 8)
        for c in range(channels):
            col = chunk[:, c]
            w.write(0, 1)  # padding bit
            if bs and np.all(col == col[0]):
                w.write(0b000000, 6)  # constant
                w.write(0, 1)         # no wasted bits
                w.write_signed(int(col[0]), bits)
            else:
                w.write(0b000001, 6)  # verbatim
                w.write(0, 1)
                if bits == 16:
                    w.write_bytes(col.astype(">i2").tobytes())
                else:
                    for v in col:
                        w.write_signed(int(v), bits)
        w.align()
        frame = w.tobytes()
        out += frame + _crc16(frame).to_bytes(2, "big")
    return bytes(out)


def save_flac(path: str, data: np.ndarray, sample_rate: int,
              bits: int = 16, block_size: int = 4096) -> None:
    """Write PCM to ``path``. Float input in [-1, 1] is quantized to ``bits``."""
    data = np.asarray(data)
    if np.issubdtype(data.dtype, np.floating):
        scale = float((1 << (bits - 1)) - 1)
        data = np.clip(np.round(data * scale),
                       -(1 << (bits - 1)), scale).astype(np.int64)
    with open(path, "wb") as f:
        f.write(encode_flac(data, sample_rate, bits, block_size))
