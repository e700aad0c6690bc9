"""Pure-Python FLAC decoder/encoder.

Full subset decoder: CONSTANT / VERBATIM / FIXED(0-4) / LPC subframes,
Rice/Rice2 residual partitions, wasted bits, and all four stereo channel
assignments.  The encoder writes valid streams with VERBATIM subframes
(correct CRCs; no compression) — enough for the reference's degraded-audio
cache files (reference eval.py:321).

The VCTK evaluation set ships as 48 kHz FLAC (SURVEY §3.2), so FLAC decode
is a first-class IO capability, not an optional extra.
"""

from __future__ import annotations

import numpy as np

FIXED_COEFFS = {
    0: [],
    1: [1],
    2: [2, -1],
    3: [3, -3, 1],
    4: [4, -6, 4, -1],
}

SR_TABLE = {
    1: 88200, 2: 176400, 3: 192000, 4: 8000, 5: 16000, 6: 22050,
    7: 24000, 8: 32000, 9: 44100, 10: 48000, 11: 96000,
}
SS_TABLE = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}


class BitReader:
    def __init__(self, buf: bytes, byte_pos: int = 0):
        self.buf = buf
        self.pos = byte_pos  # byte position
        self.acc = 0
        self.nbits = 0

    def _fill(self, need):
        while self.nbits < need:
            self.acc = (self.acc << 8) | self.buf[self.pos]
            self.pos += 1
            self.nbits += 8

    def read(self, n):
        if n == 0:
            return 0
        self._fill(n)
        self.nbits -= n
        val = (self.acc >> self.nbits) & ((1 << n) - 1)
        self.acc &= (1 << self.nbits) - 1
        return val

    def read_signed(self, n):
        v = self.read(n)
        return v - (1 << n) if v >= (1 << (n - 1)) else v

    def read_unary(self):
        q = 0
        while self.read(1) == 0:
            q += 1
        return q

    def align(self):
        drop = self.nbits % 8
        if drop:
            self.read(drop)

    def byte_position(self):
        return self.pos - self.nbits // 8

    def eof(self):
        return self.nbits == 0 and self.pos >= len(self.buf)

    def read_utf8_number(self):
        b0 = self.read(8)
        if b0 < 0x80:
            return b0
        n = 0
        mask = 0x80
        while b0 & mask:
            n += 1
            mask >>= 1
        val = b0 & (mask - 1)
        for _ in range(n - 1):
            val = (val << 6) | (self.read(8) & 0x3F)
        return val


def _decode_residual(br: BitReader, block_size: int, order: int):
    method = br.read(2)
    if method > 1:
        raise ValueError("reserved residual coding method")
    plen = 4 if method == 0 else 5
    escape = (1 << plen) - 1
    porder = br.read(4)
    n_part = 1 << porder
    res = np.empty(block_size - order, dtype=np.int64)
    idx = 0
    for p in range(n_part):
        count = (block_size >> porder) - (order if p == 0 else 0)
        param = br.read(plen)
        if param == escape:
            raw = br.read(5)
            for i in range(count):
                res[idx] = br.read_signed(raw) if raw else 0
                idx += 1
        else:
            for i in range(count):
                q = br.read_unary()
                r = br.read(param) if param else 0
                u = (q << param) | r
                res[idx] = (u >> 1) ^ -(u & 1)  # zigzag
                idx += 1
    return res


def _reconstruct_fixed(order, warm, res):
    """Invert the order-k fixed predictor (residual = k-th finite
    difference) with k vectorized cumulative sums seeded from the warmup
    difference triangle — no per-sample Python loop."""
    if order == 0:
        return np.asarray(res, dtype=np.int64)
    w = np.asarray(warm, dtype=np.int64)
    seeds = []
    for _ in range(order):
        seeds.append(w[0])
        w = np.diff(w)
    seq = np.asarray(res, dtype=np.int64)
    for j in range(order - 1, -1, -1):
        seq = np.cumsum(np.concatenate([[seeds[j]], seq]))
    return seq


def _reconstruct_lpc(order, warm, res, coefs, shift):
    x = np.concatenate([np.asarray(warm, dtype=np.int64), res])
    for i in range(order, len(x)):
        acc = 0
        for j in range(order):
            acc += coefs[j] * x[i - 1 - j]
        x[i] += acc >> shift
    return x


def _decode_subframe(br: BitReader, block_size: int, bps: int):
    if br.read(1) != 0:
        raise ValueError("invalid subframe padding bit")
    stype = br.read(6)
    wasted = 0
    if br.read(1):
        wasted = br.read_unary() + 1
    ebps = bps - wasted
    if stype == 0:  # CONSTANT
        v = br.read_signed(ebps)
        x = np.full(block_size, v, dtype=np.int64)
    elif stype == 1:  # VERBATIM
        x = np.array([br.read_signed(ebps) for _ in range(block_size)], dtype=np.int64)
    elif 8 <= stype <= 12:  # FIXED
        order = stype & 0x07
        warm = [br.read_signed(ebps) for _ in range(order)]
        res = _decode_residual(br, block_size, order)
        x = _reconstruct_fixed(order, warm, res)
    elif stype >= 32:  # LPC
        order = (stype & 0x1F) + 1
        warm = [br.read_signed(ebps) for _ in range(order)]
        precision = br.read(4) + 1
        shift = br.read_signed(5)
        coefs = [br.read_signed(precision) for _ in range(order)]
        res = _decode_residual(br, block_size, order)
        x = _reconstruct_lpc(order, warm, res, coefs, shift)
    else:
        raise ValueError(f"reserved subframe type {stype}")
    if wasted:
        x = x << wasted
    return x


def decode_flac(path, raw=False):
    """-> (float32 in [-1,1], sr); with raw=True -> (int array, sr, bps)."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:4] != b"fLaC":
        raise ValueError(f"{path}: not a FLAC stream")
    pos = 4
    sr = channels = bps = None
    while True:
        hdr = buf[pos]
        last = bool(hdr & 0x80)
        btype = hdr & 0x7F
        blen = int.from_bytes(buf[pos + 1 : pos + 4], "big")
        body = buf[pos + 4 : pos + 4 + blen]
        if btype == 0:  # STREAMINFO
            br = BitReader(body)
            br.read(16)  # min block
            br.read(16)  # max block
            br.read(24)  # min frame
            br.read(24)  # max frame
            sr = br.read(20)
            channels = br.read(3) + 1
            bps = br.read(5) + 1
            br.read(36)  # total samples
        pos += 4 + blen
        if last:
            break
    if sr is None:
        raise ValueError(f"{path}: missing STREAMINFO")

    br = BitReader(buf, pos)
    chunks = []
    while True:
        # Skip any inter-frame garbage by requiring byte-aligned sync.
        if br.byte_position() >= len(buf) - 2:
            break
        sync = br.read(14)
        if sync != 0x3FFE:
            raise ValueError(f"{path}: lost frame sync")
        br.read(1)  # reserved
        br.read(1)  # blocking strategy
        bs_code = br.read(4)
        sr_code = br.read(4)
        ch_code = br.read(4)
        ss_code = br.read(3)
        br.read(1)
        br.read_utf8_number()
        if bs_code == 1:
            block_size = 192
        elif 2 <= bs_code <= 5:
            block_size = 576 << (bs_code - 2)
        elif bs_code == 6:
            block_size = br.read(8) + 1
        elif bs_code == 7:
            block_size = br.read(16) + 1
        elif bs_code >= 8:
            block_size = 256 << (bs_code - 8)
        else:
            raise ValueError("reserved block size code")
        if sr_code == 12:
            br.read(8)
        elif sr_code in (13, 14):
            br.read(16)
        fbps = SS_TABLE.get(ss_code, bps)
        br.read(8)  # header CRC-8
        if ch_code < 8:
            n_ch = ch_code + 1
            subs = [_decode_subframe(br, block_size, fbps) for _ in range(n_ch)]
        else:
            # side channel carries one extra bit
            if ch_code == 8:  # left/side
                left = _decode_subframe(br, block_size, fbps)
                side = _decode_subframe(br, block_size, fbps + 1)
                subs = [left, left - side]
            elif ch_code == 9:  # right/side
                side = _decode_subframe(br, block_size, fbps + 1)
                right = _decode_subframe(br, block_size, fbps)
                subs = [right + side, right]
            elif ch_code == 10:  # mid/side
                mid = _decode_subframe(br, block_size, fbps)
                side = _decode_subframe(br, block_size, fbps + 1)
                m2 = (mid << 1) | (side & 1)
                subs = [(m2 + side) >> 1, (m2 - side) >> 1]
            else:
                raise ValueError("reserved channel assignment")
        br.align()
        br.read(16)  # frame CRC-16
        chunks.append(np.stack(subs, axis=1))
        # Probe for EOF: skip trailing padding bytes
        if br.byte_position() >= len(buf) - 2:
            break
    data = np.concatenate(chunks, axis=0)
    if raw:
        if data.shape[1] == 1:
            data = data[:, 0]
        return data, sr, bps
    x = data.astype(np.float32) / float(1 << (bps - 1))
    if x.shape[1] == 1:
        x = x[:, 0]
    return x, sr


# --------------------------------------------------------------------------
# Encoder (VERBATIM subframes; valid CRCs)
# --------------------------------------------------------------------------


class BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.nbits = 0

    def write(self, val, n):
        if n == 0:
            return
        self.acc = (self.acc << n) | (val & ((1 << n) - 1))
        self.nbits += n
        while self.nbits >= 8:
            self.nbits -= 8
            self.out.append((self.acc >> self.nbits) & 0xFF)
        self.acc &= (1 << self.nbits) - 1

    def align(self):
        if self.nbits:
            self.write(0, 8 - self.nbits)

    def bytes(self):
        assert self.nbits == 0
        return bytes(self.out)


def _crc8(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b
        for _ in range(8):
            crc = ((crc << 1) ^ 0x07) & 0xFF if crc & 0x80 else (crc << 1) & 0xFF
    return crc


def _crc16_step(crc: np.ndarray, byte: np.ndarray) -> np.ndarray:
    """One byte of CRC-16 (poly 0x8005, MSB first) on uint16 lanes."""
    return ((crc << 8) & 0xFFFF) ^ _CRC16_TABLE[(crc >> 8) ^ byte]


def _crc16_table() -> np.ndarray:
    t = np.zeros(256, np.int64)
    for b in range(256):
        crc = b << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x8005) & 0xFFFF if crc & 0x8000 else (crc << 1) & 0xFFFF
        t[b] = crc
    return t


_CRC16_TABLE = _crc16_table()
_CRC16_LANE = 64  # bytes per lane


def _crc16_shift_tables(n_bytes: int):
    """(hi, lo) tables of the linear map 'append n_bytes zero bytes' on a
    CRC: shift(c) = hi[c >> 8] ^ lo[c & 0xFF]."""
    v = np.arange(256, dtype=np.int64)
    hi, lo = v << 8, v.copy()
    zero = np.zeros(256, np.int64)
    for _ in range(n_bytes):
        hi, lo = _crc16_step(hi, zero), _crc16_step(lo, zero)
    return hi, lo


_CRC16_SHIFT = _crc16_shift_tables(_CRC16_LANE)


def _crc16(data: bytes) -> int:
    """FLAC frame CRC-16.  With a zero initial value the CRC is linear and
    leading zero bytes leave it unchanged, so the zero-padded message is cut
    into 64-byte lanes whose CRCs run in lockstep (numpy), then folded:
    crc = shift(crc) ^ lane_crc."""
    buf = np.frombuffer(data, np.uint8).astype(np.int64)
    pad = -len(buf) % _CRC16_LANE
    lanes = np.concatenate([np.zeros(pad, np.int64), buf]).reshape(-1, _CRC16_LANE)
    crc = np.zeros(lanes.shape[0], np.int64)
    for i in range(_CRC16_LANE):
        crc = _crc16_step(crc, lanes[:, i])
    hi, lo = _CRC16_SHIFT
    total = 0
    for c in crc.tolist():
        total = int(hi[total >> 8] ^ lo[total & 0xFF]) ^ c
    return total


def _utf8_number(n: int) -> bytes:
    if n < 0x80:
        return bytes([n])
    out = []
    nbytes = 2
    while n >= (1 << (6 * (nbytes - 1) + (7 - nbytes))):
        nbytes += 1
    lead = (0xFF << (8 - nbytes)) & 0xFF
    shift = 6 * (nbytes - 1)
    out.append(lead | ((n >> shift) & ((1 << (7 - nbytes)) - 1)))
    for i in range(nbytes - 1):
        shift -= 6
        out.append(0x80 | ((n >> shift) & 0x3F))
    return bytes(out)


def encode_flac(path, data: np.ndarray, sr: int, bps: int = 16, block_size: int = 4096):
    data = np.asarray(data)
    if data.ndim == 1:
        data = data[:, None]
    n, n_ch = data.shape
    pcm = np.clip(np.round(data * (1 << (bps - 1))), -(1 << (bps - 1)), (1 << (bps - 1)) - 1).astype(np.int64)

    hdr = BitWriter()
    hdr.write(0x664C6143, 32)  # fLaC
    # STREAMINFO, last-metadata
    hdr.write(0x80, 8)
    hdr.write(34, 24)
    hdr.write(block_size, 16)
    hdr.write(block_size, 16)
    hdr.write(0, 24)
    hdr.write(0, 24)
    hdr.write(sr, 20)
    hdr.write(n_ch - 1, 3)
    hdr.write(bps - 1, 5)
    hdr.write(n, 36)
    for _ in range(16):
        hdr.write(0, 8)  # md5 unknown
    stream = bytearray(hdr.bytes())

    n_frames = -(-n // block_size)
    for fi in range(n_frames):
        blk = pcm[fi * block_size : (fi + 1) * block_size]
        bs = blk.shape[0]
        fw = BitWriter()
        fw.write(0x3FFE, 14)
        fw.write(0, 1)
        fw.write(0, 1)  # fixed blocksize strategy
        fw.write(7, 4)  # 16-bit block size follows header number
        fw.write(0, 4)  # sample rate from STREAMINFO
        fw.write(n_ch - 1, 4)  # independent channels
        ss_code = {8: 1, 12: 2, 16: 4, 20: 5, 24: 6, 32: 7}[bps]
        fw.write(ss_code, 3)
        fw.write(0, 1)
        for b in _utf8_number(fi):
            fw.write(b, 8)
        fw.write(bs - 1, 16)
        fw.align()
        head = fw.bytes()
        head += bytes([_crc8(head)])

        if bps % 8 == 0:
            # Byte-aligned VERBATIM subframes: the header byte (zero pad,
            # type 1, no wasted bits) and big-endian two's-complement samples.
            nb = bps // 8
            body = b"".join(
                b"\x02" + blk[:, c].astype(">i8").view(np.uint8).reshape(bs, 8)[:, 8 - nb :].tobytes()
                for c in range(n_ch)
            )
        else:
            bw = BitWriter()
            for c in range(n_ch):
                bw.write(0, 1)
                bw.write(1, 6)  # VERBATIM
                bw.write(0, 1)
                for v in blk[:, c]:
                    bw.write(int(v), bps)
            bw.align()
            body = bw.bytes()
        frame = head + body
        crc = _crc16(frame)
        stream += frame + bytes([crc >> 8, crc & 0xFF])

    with open(path, "wb") as f:
        f.write(bytes(stream))
