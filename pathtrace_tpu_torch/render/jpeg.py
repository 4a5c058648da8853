"""Minimal baseline and progressive JPEG decoder (pure numpy, no
external codecs), the port's copy of ``pathtrace_tpu/render/jpeg.py``.

The reference loads image textures through the ``image`` crate, whose own
asset is ``earthmap.jpg`` (reference ``src/texture.rs:14-20`` --
``image::open(path)`` handles any format). The port's PNG reader lives in
:mod:`pathtrace_tpu_torch.render.film`; this module is the JPEG half, so
``--image`` takes the reference's asset class without external deps.

Scope: baseline sequential DCT (SOF0), extended sequential (SOF1) and
progressive (SOF2 -- spectral selection + successive approximation, DC and
AC first/refinement scans, interleaved DC scans, non-interleaved AC scans),
8-bit, grayscale or YCbCr with any (h, v) sampling factors up to 2
(4:4:4, 4:2:2, 4:2:0), restart intervals. Decode strategy: python-level
Huffman passes collect all coefficient blocks (progressive scans refine
them in place), then dequantization + 2-D IDCT run batched in numpy
(``D.T @ block @ D``), so the per-pixel math is vectorized.
"""

from __future__ import annotations

import struct

import numpy as np

# zig-zag order: index i of the scan -> (row, col) flat index
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
], np.int32)

# 8x8 DCT-II basis: pixel = D.T @ coeff @ D with orthonormal scaling
_D = np.zeros((8, 8), np.float64)
for _k in range(8):
    for _n in range(8):
        _D[_k, _n] = np.cos((2 * _n + 1) * _k * np.pi / 16.0) * (
            np.sqrt(0.125) if _k == 0 else 0.5
        )


class JpegError(ValueError):
    pass


class _Huffman:
    """Canonical Huffman table: (length, code) -> symbol lookup dict."""

    __slots__ = ("lut", "max_len")

    def __init__(self, bits, values):
        self.lut = {}
        code = 0
        k = 0
        self.max_len = 0
        for length in range(1, 17):
            for _ in range(bits[length - 1]):
                self.lut[(length, code)] = values[k]
                code += 1
                k += 1
                self.max_len = length
            code <<= 1


class _BitReader:
    """MSB-first bit reader over entropy-coded data with 0xFF00 unstuffing.

    Restart markers (FFD0-FFD7) are consumed by :meth:`restart`."""

    __slots__ = ("data", "pos", "bitbuf", "bitcnt")

    def __init__(self, data: bytes, pos: int):
        self.data = data
        self.pos = pos
        self.bitbuf = 0
        self.bitcnt = 0

    def _fill(self):
        d = self.data
        while self.bitcnt <= 24:
            if self.pos >= len(d):
                self.bitbuf = (self.bitbuf << 8) | 0  # pad past EOI
                self.bitcnt += 8
                continue
            b = d[self.pos]
            if b == 0xFF:
                nxt = d[self.pos + 1] if self.pos + 1 < len(d) else 0xD9
                if nxt == 0x00:
                    self.pos += 2
                else:
                    # any real marker ends the entropy-coded data: RST is
                    # consumed by restart(); EOI/DHT/SOS/... terminate the
                    # scan (progressive streams put the next scan's headers
                    # right here). Stop feeding real bits, don't advance.
                    self.bitbuf = (self.bitbuf << 8) | 0
                    self.bitcnt += 8
                    continue
            else:
                self.pos += 1
            self.bitbuf = (self.bitbuf << 8) | b
            self.bitcnt += 8

    def bits(self, n: int) -> int:
        if n == 0:
            return 0
        if self.bitcnt < n:
            self._fill()
        self.bitcnt -= n
        v = (self.bitbuf >> self.bitcnt) & ((1 << n) - 1)
        self.bitbuf &= (1 << self.bitcnt) - 1
        return v

    def decode(self, table: _Huffman) -> int:
        code = 0
        for length in range(1, table.max_len + 1):
            code = (code << 1) | self.bits(1)
            sym = table.lut.get((length, code))
            if sym is not None:
                return sym
        raise JpegError("invalid Huffman code in scan")

    def restart(self) -> None:
        """Byte-align and consume an RSTn marker; reset the bit buffer."""
        self.bitbuf = 0
        self.bitcnt = 0
        d = self.data
        while self.pos + 1 < len(d):
            if d[self.pos] == 0xFF and 0xD0 <= d[self.pos + 1] <= 0xD7:
                self.pos += 2
                return
            self.pos += 1
        raise JpegError("missing restart marker")


def _extend(v: int, n: int) -> int:
    """JPEG F.2.2.1 sign extension of an n-bit magnitude."""
    if n == 0:
        return 0
    return v if v >= (1 << (n - 1)) else v - (1 << n) + 1


def decode_jpeg(data: bytes) -> np.ndarray:
    """Decode JPEG bytes (baseline or progressive) to ``[h, w, 3]`` uint8."""
    if len(data) < 4 or data[0] != 0xFF or data[1] != 0xD8:
        raise JpegError("not a JPEG (missing SOI)")
    pos = 2
    qtables = {}
    dc_tables = {}
    ac_tables = {}
    restart_interval = 0
    frame = None           # (h, w, [(cid, hs, vs, tq)])
    progressive = False
    pstate = None          # progressive per-component coefficient stores

    while pos < len(data):
        if data[pos] != 0xFF:
            raise JpegError(f"expected marker at {pos}")
        marker = data[pos + 1]
        pos += 2
        if marker == 0xD9:  # EOI
            break
        if marker in (0x01,) or 0xD0 <= marker <= 0xD7:
            continue
        seg_len = struct.unpack(">H", data[pos:pos + 2])[0]
        seg = data[pos + 2:pos + seg_len]
        if marker == 0xDB:  # DQT
            p = 0
            while p < len(seg):
                pq, tq = seg[p] >> 4, seg[p] & 15
                p += 1
                if pq:
                    q = np.frombuffer(seg[p:p + 128], ">u2").astype(np.int32)
                    p += 128
                else:
                    q = np.frombuffer(seg[p:p + 64], np.uint8).astype(np.int32)
                    p += 64
                qtables[tq] = q
        elif marker == 0xC4:  # DHT
            p = 0
            while p < len(seg):
                tc, th = seg[p] >> 4, seg[p] & 15
                bits = list(seg[p + 1:p + 17])
                n = sum(bits)
                vals = list(seg[p + 17:p + 17 + n])
                (dc_tables if tc == 0 else ac_tables)[th] = _Huffman(bits, vals)
                p += 17 + n
        elif marker in (0xC0, 0xC1, 0xC2):  # SOF0 / SOF1 / SOF2
            precision = seg[0]
            if precision != 8:
                raise JpegError(f"{precision}-bit JPEG unsupported")
            h, w = struct.unpack(">HH", seg[1:5])
            ncomp = seg[5]
            comps = []
            for i in range(ncomp):
                cid, hv, tq = seg[6 + 3 * i:9 + 3 * i]
                comps.append((cid, hv >> 4, hv & 15, tq))
            frame = (h, w, comps)
            progressive = marker == 0xC2
            if progressive:
                pstate = _alloc_prog_state(frame)
        elif marker == 0xDD:  # DRI
            restart_interval = struct.unpack(">H", seg[:2])[0]
        elif marker == 0xDA:  # SOS
            if frame is None:
                raise JpegError("SOS before SOF")
            ns = seg[0]
            scan = []
            for i in range(ns):
                cs, tdta = seg[1 + 2 * i:3 + 2 * i]
                scan.append((cs, tdta >> 4, tdta & 15))
            if not progressive:
                return _decode_scan(
                    data, pos + seg_len, frame, scan, qtables,
                    dc_tables, ac_tables, restart_interval,
                )
            # progressive: spectral selection + successive approximation
            ss = seg[1 + 2 * ns]
            se = seg[2 + 2 * ns]
            ahal = seg[3 + 2 * ns]
            pos = _decode_scan_prog(
                data, pos + seg_len, frame, pstate, scan,
                ss, se, ahal >> 4, ahal & 15,
                dc_tables, ac_tables, restart_interval,
            )
            continue
        pos += seg_len
    if progressive and pstate is not None:
        return _reconstruct_prog(frame, pstate, qtables)
    raise JpegError("no scan data (missing SOS)")


def _frame_geometry(frame):
    h, w, comps = frame
    hmax = max(hs for _, hs, _, _ in comps)
    vmax = max(vs for _, _, vs, _ in comps)
    mcux = (w + 8 * hmax - 1) // (8 * hmax)
    mcuy = (h + 8 * vmax - 1) // (8 * vmax)
    return hmax, vmax, mcux, mcuy


def _alloc_prog_state(frame):
    """Per-component coefficient stores for progressive decoding.

    Blocks are stored at the interleaved-MCU grid stride (``bw`` per row)
    so interleaved DC scans and non-interleaved AC scans index the same
    arrays; ``nbw``/``nbh`` are the non-interleaved (component-raster)
    block counts (JPEG A.2.2).
    """
    h, w, comps = frame
    hmax, vmax, mcux, mcuy = _frame_geometry(frame)
    state = {}
    for cid, hs, vs, tq in comps:
        bw = mcux * hs
        bh = mcuy * vs
        cw = (w * hs + hmax - 1) // hmax
        ch = (h * vs + vmax - 1) // vmax
        state[cid] = {
            "hs": hs, "vs": vs, "tq": tq,
            "coef": np.zeros((bw * bh, 64), np.int32),
            "bw": bw,
            "nbw": (cw + 7) // 8, "nbh": (ch + 7) // 8,
            "pred": 0,
        }
    return state


def _next_marker_pos(data, pos):
    """First position at/after ``pos`` of a real marker (not stuffing/RST)."""
    n = len(data)
    while pos + 1 < n:
        if data[pos] == 0xFF and data[pos + 1] != 0x00 and not (
                0xD0 <= data[pos + 1] <= 0xD7):
            return pos
        pos += 1
    return n


def _decode_scan_prog(data, pos, frame, pstate, scan, ss, se, ah, al,
                      dc_tables, ac_tables, restart_interval):
    """One progressive scan (JPEG G.1.2): DC first/refine (possibly
    interleaved), AC first/refine (always one component). Refines the
    per-component coefficient stores in place; returns the parse position
    of the next marker after the entropy-coded data."""
    rd = _BitReader(bytes(data), pos)
    zz = _ZIGZAG

    if ss == 0:
        # ---- DC scan ----
        if se != 0:
            raise JpegError("DC progressive scan with Se != 0")
        comps = []
        for cs, td, _ta in scan:
            c = pstate[cs]
            c["pred"] = 0
            comps.append((c, dc_tables.get(td)))
        hmax, vmax, mcux, mcuy = _frame_geometry(frame)
        interleaved = len(scan) > 1
        if interleaved:
            units = [(mx, my) for my in range(mcuy) for mx in range(mcux)]
        else:
            c0 = comps[0][0]
            units = [(bx, by) for by in range(c0["nbh"])
                     for bx in range(c0["nbw"])]
        count = 0
        for ux, uy in units:
            if restart_interval and count and count % restart_interval == 0:
                rd.restart()
                for c, _ in comps:
                    c["pred"] = 0
            for c, dc in comps:
                if interleaved:
                    blocks = [
                        (uy * c["vs"] + v) * c["bw"] + ux * c["hs"] + u
                        for v in range(c["vs"]) for u in range(c["hs"])
                    ]
                else:
                    blocks = [uy * c["bw"] + ux]
                for bi in blocks:
                    blk = c["coef"][bi]
                    if ah == 0:
                        s = rd.decode(dc)
                        diff = _extend(rd.bits(s), s)
                        c["pred"] += diff
                        blk[0] = c["pred"] << al
                    else:
                        # refinement: append one magnitude bit
                        if rd.bits(1):
                            blk[0] |= 1 << al
            count += 1
        return _next_marker_pos(data, rd.pos)

    # ---- AC scan: exactly one component, component-raster block order ----
    if len(scan) != 1:
        raise JpegError("interleaved AC progressive scan")
    cs, _td, ta = scan[0]
    c = pstate[cs]
    ac = ac_tables[ta]
    coef = c["coef"]
    bw = c["bw"]
    eobrun = 0
    p1 = 1 << al
    m1 = -p1
    count = 0
    for by in range(c["nbh"]):
        for bx in range(c["nbw"]):
            if restart_interval and count and count % restart_interval == 0:
                rd.restart()
                eobrun = 0
            count += 1
            blk = coef[by * bw + bx]
            if ah == 0:
                # first scan of this band
                if eobrun:
                    eobrun -= 1
                    continue
                k = ss
                while k <= se:
                    rs = rd.decode(ac)
                    r, s = rs >> 4, rs & 15
                    if s == 0:
                        if r == 15:      # ZRL
                            k += 16
                            continue
                        eobrun = (1 << r) - 1
                        if r:
                            eobrun += rd.bits(r)
                        break            # EOBn
                    k += r
                    if k > se:
                        raise JpegError("AC index past Se")
                    blk[zz[k]] = _extend(rd.bits(s), s) << al
                    k += 1
                continue

            # refinement scan (G.1.2.3): correction bits for known-nonzero
            # coefficients, new +-1<<Al coefficients elsewhere
            def refine(blk, k):
                v = blk[zz[k]]
                if v != 0 and rd.bits(1) and (v & p1) == 0:
                    blk[zz[k]] = v + (p1 if v >= 0 else m1)

            k = ss
            if eobrun == 0:
                while k <= se:
                    rs = rd.decode(ac)
                    r, s = rs >> 4, rs & 15
                    newval = 0
                    if s == 0:
                        if r < 15:
                            eobrun = (1 << r)
                            if r:
                                eobrun += rd.bits(r)
                            break
                        # r == 15: pass over 16 zero-history coefficients
                    else:
                        if s != 1:
                            raise JpegError("bad AC refinement symbol")
                        newval = p1 if rd.bits(1) else m1
                    while k <= se:
                        if blk[zz[k]] != 0:
                            refine(blk, k)
                        else:
                            if r == 0:
                                break
                            r -= 1
                        k += 1
                    if newval and k <= se:
                        blk[zz[k]] = newval
                    k += 1
            if eobrun > 0:
                # the EOB run refines this block's remaining nonzeros too
                while k <= se:
                    refine(blk, k)
                    k += 1
                eobrun -= 1
    return _next_marker_pos(data, rd.pos)


def _reconstruct_prog(frame, pstate, qtables):
    """Dequantize + IDCT + upsample + color-convert the progressive state
    (same batched math as the baseline path's tail)."""
    h, w, comps = frame
    hmax, vmax, _, _ = _frame_geometry(frame)
    zz = _ZIGZAG
    planes = []
    for cid, hs, vs, tq in comps:
        c = pstate[cid]
        q = np.zeros(64, np.int32)
        q[zz] = qtables[tq]
        coef = (c["coef"] * q[None, :]).astype(np.float64).reshape(-1, 8, 8)
        bw = c["bw"]
        bh = coef.shape[0] // bw
        pix = np.einsum("ki,nkl,lj->nij", _D, coef, _D) + 128.0
        plane = pix.reshape(bh, bw, 8, 8).transpose(0, 2, 1, 3).reshape(
            bh * 8, bw * 8
        )
        ry, rx = vmax // vs, hmax // hs
        if ry > 1 or rx > 1:
            plane = plane.repeat(ry, axis=0).repeat(rx, axis=1)
        planes.append(plane[:h, :w])

    if len(planes) == 1:
        y = np.clip(np.round(planes[0]), 0, 255).astype(np.uint8)
        return np.stack([y, y, y], axis=-1)
    if len(planes) != 3:
        raise JpegError(f"{len(planes)}-component JPEG unsupported")
    y, cb, cr = planes
    r = y + 1.402 * (cr - 128.0)
    g = y - 0.344136 * (cb - 128.0) - 0.714136 * (cr - 128.0)
    b = y + 1.772 * (cb - 128.0)
    rgb = np.stack([r, g, b], axis=-1)
    return np.clip(np.round(rgb), 0, 255).astype(np.uint8)


def _decode_scan(data, pos, frame, scan, qtables, dc_tables, ac_tables,
                 restart_interval):
    h, w, comps = frame
    by_id = {cid: (hs, vs, tq) for cid, hs, vs, tq in comps}
    hmax = max(hs for _, hs, _, _ in comps)
    vmax = max(vs for _, _, vs, _ in comps)
    mcux = (w + 8 * hmax - 1) // (8 * hmax)
    mcuy = (h + 8 * vmax - 1) // (8 * vmax)

    # per scan component: sampling, tables, coefficient-block store
    sc = []
    for cs, td, ta in scan:
        hs, vs, tq = by_id[cs]
        n_blocks = mcux * hs * mcuy * vs
        sc.append({
            "hs": hs, "vs": vs, "q": qtables[tq],
            "dc": dc_tables[td], "ac": ac_tables[ta],
            "coef": np.zeros((n_blocks, 64), np.int32),
            "bw": mcux * hs,  # blocks per row
            "pred": 0,
        })

    rd = _BitReader(bytes(data), pos)
    zz = _ZIGZAG
    mcu_count = 0
    for my in range(mcuy):
        for mx in range(mcux):
            if restart_interval and mcu_count and \
                    mcu_count % restart_interval == 0:
                rd.restart()
                for c in sc:
                    c["pred"] = 0
            for c in sc:
                for v in range(c["vs"]):
                    for u in range(c["hs"]):
                        blk = c["coef"][
                            (my * c["vs"] + v) * c["bw"] + mx * c["hs"] + u
                        ]
                        # DC
                        s = rd.decode(c["dc"])
                        diff = _extend(rd.bits(s), s)
                        c["pred"] += diff
                        blk[0] = c["pred"]
                        # AC
                        k = 1
                        while k < 64:
                            rs = rd.decode(c["ac"])
                            r, s = rs >> 4, rs & 15
                            if s == 0:
                                if r == 15:   # ZRL
                                    k += 16
                                    continue
                                break         # EOB
                            k += r
                            if k > 63:
                                raise JpegError("AC index overflow")
                            blk[zz[k]] = _extend(rd.bits(s), s)
                            k += 1
            mcu_count += 1

    # batched dequant + IDCT per component, then upsample + color convert
    planes = []
    for c in sc:
        q = np.zeros(64, np.int32)
        q[zz] = c["q"]                       # de-zigzag the quant table
        coef = (c["coef"] * q[None, :]).astype(np.float64).reshape(-1, 8, 8)
        pix = np.einsum("ki,nkl,lj->nij", _D, coef, _D) + 128.0
        bw = c["bw"]
        bh = coef.shape[0] // bw
        plane = pix.reshape(bh, bw, 8, 8).transpose(0, 2, 1, 3).reshape(
            bh * 8, bw * 8
        )
        # upsample to full MCU-padded resolution by replication, crop to w,h
        ry, rx = vmax // c["vs"], hmax // c["hs"]
        if ry > 1 or rx > 1:
            plane = plane.repeat(ry, axis=0).repeat(rx, axis=1)
        planes.append(plane[:h, :w])

    if len(planes) == 1:
        y = np.clip(np.round(planes[0]), 0, 255).astype(np.uint8)
        return np.stack([y, y, y], axis=-1)
    if len(planes) != 3:
        raise JpegError(f"{len(planes)}-component JPEG unsupported")
    y, cb, cr = planes
    r = y + 1.402 * (cr - 128.0)
    g = y - 0.344136 * (cb - 128.0) - 0.714136 * (cr - 128.0)
    b = y + 1.772 * (cb - 128.0)
    rgb = np.stack([r, g, b], axis=-1)
    return np.clip(np.round(rgb), 0, 255).astype(np.uint8)


def read_jpeg(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_jpeg(f.read())
