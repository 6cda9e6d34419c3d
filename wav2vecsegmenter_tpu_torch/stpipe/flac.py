"""FLAC encoding for the ST-eval ``use_audio_input`` path.

The reference writes per-segment flac files with soundfile
(lib/eval_scripts/prepare_custom_dataset.py:104-125); this environment has
no libsndfile, so encoding is done by the native C++ encoder
(native/audio/flac_writer.cpp) with a bit-identical pure-Python fallback.
Streams are 16-bit mono with VERBATIM subframes (CONSTANT for silent
blocks) — fully spec-conformant FLAC that any libsndfile/ffmpeg consumer
(the external fairseq install) decodes bit-exactly.

``decode_flac`` is a decoder for the subset this module emits (plus
fixed-predictor subframes are NOT supported) — used by tests to round-trip
and by any in-repo consumer of the flac.zip.

The port's copy of ``wav2vecsegmenter_tpu/stpipe/flac.py``
(tests/test_torch_copies.py holds the two equal).
"""

from __future__ import annotations

import numpy as np

BLOCK = 4096


def _crc8(data: bytes) -> int:
    crc = 0
    for byte in data:
        crc ^= byte
        for _ in range(8):
            crc = ((crc << 1) ^ 0x07 if crc & 0x80 else crc << 1) & 0xFF
    return crc


def _crc16(data: bytes) -> int:
    crc = 0
    for byte in data:
        crc ^= byte << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x8005 if crc & 0x8000 else crc << 1) & 0xFFFF
    return crc


def _utf8_number(v: int) -> bytes:
    """FLAC's extended-UTF-8 coding of the frame number."""
    if v < 0x80:
        return bytes([v])
    n = 2
    lim = 0x800
    while v >= lim and n < 7:
        lim <<= 5
        n += 1
    out = bytearray(n)
    for i in range(n - 1, 0, -1):
        out[i] = 0x80 | (v & 0x3F)
        v >>= 6
    out[0] = ((0xFF << (8 - n)) & 0xFF) | v
    return bytes(out)


def to_int16(samples: np.ndarray) -> np.ndarray:
    """float [-1,1] -> int16 (torchaudio/soundfile convention)."""
    if samples.dtype == np.int16:
        return samples
    return np.clip(np.asarray(samples) * 32768.0, -32768, 32767).astype("<i2")


def _encode_flac_py(samples: np.ndarray, sample_rate: int) -> bytes:
    samples = np.ascontiguousarray(samples, dtype=np.int16)
    n = len(samples)
    out = bytearray()
    out += b"fLaC"
    si = bytearray(34)
    si[0:2] = BLOCK.to_bytes(2, "big")
    si[2:4] = BLOCK.to_bytes(2, "big")
    # bytes 4..9: min/max framesize 0 = unknown
    si[10] = (sample_rate >> 12) & 0xFF
    si[11] = (sample_rate >> 4) & 0xFF
    si[12] = ((sample_rate & 0xF) << 4) | (0 << 1) | ((15 >> 4) & 0x1)
    si[13] = ((15 & 0xF) << 4) | ((n >> 32) & 0xF)
    si[14:18] = (n & 0xFFFFFFFF).to_bytes(4, "big")
    # bytes 18..33: MD5 unknown (zeros)
    out += bytes([0x80]) + (34).to_bytes(3, "big") + si

    be = samples.astype(">i2")
    for frame_idx, pos in enumerate(range(0, n, BLOCK)):
        block = be[pos: pos + BLOCK]
        bs = len(block)
        hdr = bytearray(b"\xff\xf8\x70\x08")
        hdr += _utf8_number(frame_idx)
        hdr += (bs - 1).to_bytes(2, "big")
        hdr.append(_crc8(bytes(hdr)))
        frame = bytes(hdr)
        if bs and np.all(block == block[0]):
            frame += b"\x00" + int(block[0]).to_bytes(2, "big", signed=True)
        else:
            frame += b"\x02" + block.tobytes()
        frame += _crc16(frame).to_bytes(2, "big")
        out += frame
    return bytes(out)


def encode_flac(samples: np.ndarray, sample_rate: int = 16000) -> bytes:
    """16-bit mono FLAC bytes; native C++ encoder when available."""
    samples = to_int16(samples)
    from ..data import native_audio

    if native_audio.available():
        return native_audio.encode_flac(samples, sample_rate)
    return _encode_flac_py(samples, sample_rate)


def decode_flac(data: bytes) -> tuple[np.ndarray, int]:
    """Decode mono 16-bit FLAC with VERBATIM/CONSTANT subframes (the subset
    this module emits).  Verifies sync codes and both CRCs."""
    if data[:4] != b"fLaC":
        raise ValueError("not a FLAC stream")
    pos = 4
    sample_rate = None
    total = None
    while True:
        last = data[pos] & 0x80
        btype = data[pos] & 0x7F
        length = int.from_bytes(data[pos + 1: pos + 4], "big")
        body = data[pos + 4: pos + 4 + length]
        if btype == 0:  # STREAMINFO
            sample_rate = (body[10] << 12) | (body[11] << 4) | (body[12] >> 4)
            channels = ((body[12] >> 1) & 0x7) + 1
            bps = (((body[12] & 1) << 4) | (body[13] >> 4)) + 1
            if channels != 1 or bps != 16:
                raise ValueError("decoder supports mono 16-bit only")
            total = ((body[13] & 0xF) << 32) | int.from_bytes(
                body[14:18], "big")
        pos += 4 + length
        if last:
            break
    chunks = []
    while pos < len(data):
        fstart = pos
        if data[pos] != 0xFF or (data[pos + 1] & 0xFC) != 0xF8:
            raise ValueError(f"bad frame sync at {pos}")
        if data[pos + 2] != 0x70 or data[pos + 3] != 0x08:
            raise ValueError("unexpected frame header codes")
        pos += 4
        first = data[pos]
        n_utf8 = 1
        if first >= 0x80:
            n_utf8 = 8 - (first ^ 0xFF).bit_length()
        pos += n_utf8
        bs = int.from_bytes(data[pos: pos + 2], "big") + 1
        pos += 2
        if _crc8(data[fstart:pos]) != data[pos]:
            raise ValueError("frame header CRC-8 mismatch")
        pos += 1
        sub = data[pos]
        pos += 1
        if sub == 0x00:  # CONSTANT
            val = int.from_bytes(data[pos: pos + 2], "big", signed=True)
            chunks.append(np.full(bs, val, np.int16))
            pos += 2
        elif sub == 0x02:  # VERBATIM
            chunks.append(
                np.frombuffer(data[pos: pos + 2 * bs], ">i2").astype(np.int16)
            )
            pos += 2 * bs
        else:
            raise ValueError(f"unsupported subframe type 0x{sub:02x}")
        crc = int.from_bytes(data[pos: pos + 2], "big")
        if _crc16(data[fstart:pos]) != crc:
            raise ValueError("frame CRC-16 mismatch")
        pos += 2
    samples = (np.concatenate(chunks) if chunks
               else np.array([], np.int16))
    if total is not None and len(samples) != total:
        raise ValueError(f"decoded {len(samples)} != STREAMINFO {total}")
    return samples, sample_rate
