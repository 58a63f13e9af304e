"""First-party MPEG-audio Layer I codec (encode + decode), pure numpy.

A copy of ``sdtk_tpu/utils/mpegaudio.py``: the same bytes and samples.

Why this exists: the reference toolkit stores review samples as ``.mp3``
files produced by shelling out to ffmpeg (reference
``speaker_samples:280-326`` — ``extract_audio_segment`` with
``output_format="mp3"``), and its acceptance tests discover samples by
globbing ``samples/<speaker>/*.mp3``.  This image has no ffmpeg and no
codec libraries, so the framework carries its own MPEG audio codec the
same way it carries its own BLAKE3 (``utils/hashing.py``).

Scope (honest statement):

- **Layer I** is implemented completely from the ISO 11172-3 / 13818-3
  *formulas*: the cosine-modulated 32-band polyphase filterbank
  (analysis modulation ``cos((2i+1)(k-16)pi/64)`` over the newest-first
  512-sample X buffer; synthesis via the V/U/W flowchart with matrixing
  ``cos((16+k)(2i+1)pi/64)``), ``2.0*2^(-i/3)`` scalefactors, and the
  ISO ``(2c-(2^nb-2))/(2^nb-1)`` requantization law.  The one numeric
  table the spec has — the 512-tap filterbank window — was recovered
  bit-exactly by linear probing of a real ISO decoder (see the
  provenance note at ``_D_Q16``), so round-trips are interoperable:
  ~52 dB (quantizer-limited) through BOTH this decoder and libmpg123
  (tests/test_syscodec.py, tests/test_native_audio.py).
- **Layer II** (encode + decode) shares the same filterbank and adds
  the 1152-sample frame layout: per-subband quantizer classes from the
  five allocation tables (A/B for MPEG-1 mid/high rates, C/D for low
  rates, one LSF table for MPEG-2), scfsi scalefactor sharing on the
  decode side, grouped 3/5/9-step triplet codes.  The tables were
  written from the spec's structure and then verified — and where the
  first writing was wrong, RECOVERED — against libmpg123 probe frames;
  the shipped decoder now agrees with libmpg123 to ~135 dB (bit-exact
  float32) on every (rate, bitrate) combination
  (tests/test_syscodec.py).
- **Layer III decode is NOT implemented here** (its Huffman tables are
  large spec data blobs); real-world ``.mp3`` files decode through the
  in-process system codec (utils/syscodec.py, libmpg123) when present.
  Without it, :func:`decode` raises :class:`UnsupportedFormatError`
  with a clear message so callers (``speaker-process`` queue) can skip
  with a reason instead of crashing.

Frame layout (mono Layer I): 32-bit header, 32x4-bit allocation,
6-bit scalefactor per active band, then 12 granules x (alloc+1)-bit
codes per active band, padded to 4-byte slots.
"""

from __future__ import annotations

import numpy as np

SUBBANDS = 32
GRANULES = 12
FRAME_SAMPLES = SUBBANDS * GRANULES  # 384 per Layer I frame
_TAPS = 512

# Header enumerations (spec header fields, not DSP data tables).
_BITRATES_V1_L1 = [0, 32, 64, 96, 128, 160, 192, 224, 256, 288, 320, 352, 384, 416, 448]
_BITRATES_V2_L1 = [0, 32, 48, 56, 64, 80, 96, 112, 128, 144, 160, 176, 192, 224, 256]
_BITRATES_V1_L2 = [0, 32, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256, 320, 384]
_BITRATES_V2_L2 = [0, 8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 144, 160]
_RATES_V1 = [44100, 48000, 32000]
_RATES_V2 = [22050, 24000, 16000]

# 63 scalefactors: 2.0 * 2^(-i/3)  (ISO Layer I/II scalefactor law)
_SCALEFACTORS = 2.0 * np.power(2.0, -np.arange(63) / 3.0)


class UnsupportedFormatError(ValueError):
    """Raised for MPEG streams outside the first-party codec's scope."""


# ------------------------------------------------------------- filterbank
#
# 512-tap synthesis window of the ISO polyphase filterbank (the spec's
# table-B.3 "D[i]" coefficients), expressed in this module's folded
# V/U/W-flowchart convention and stored as Q16 fixed-point integers.
#
# Provenance (recovered, not transcribed): the r2 square-root-raised-
# cosine prototype self-decoded at ~40 dB but was only ~5 dB
# interoperable with real ISO decoders — near-perfect-reconstruction
# alone does not pin the window shape.  These taps were therefore
# MEASURED from a real decoder (libmpg123, loaded in-process via
# utils/syscodec.py): crafted Layer I streams with single-subband,
# single-granule impulses make the decoder emit each subband's synthesis
# impulse response, and the synthesis flowchart is linear and exactly
# determined, so the window solves out tap by tap (least squares across
# all 32 subbands; max model residual 2.5e-6).  The recovered taps
# snapped onto the 2^-16 grid at float32-noise residual (1.9e-7),
# i.e. the spec table was recovered bit-exactly.  Taps multiplied by an
# exactly-zero modulation cosine (j=16 at even r) are unobservable AND
# unused by the flowchart; they are stored as 0.
#
# With this window the encoder's streams decode identically (~52 dB,
# quantizer-limited) on this module's decoder and on libmpg123
# (tests/test_syscodec.py), replacing the r2 untested-interop claim.
_D_Q16 = np.array([
    0, -1, -1, -1, -1, -1, -1, -2,
    -2, -2, -2, -3, -3, -4, -4, -5,
    0, -6, -7, -7, -8, -9, -10, -11,
    -13, -14, -16, -17, -19, -21, -24, -26,
    -29, -31, -35, -38, -41, -45, -49, -53,
    -58, -63, -68, -73, -79, -85, -91, -97,
    -104, -111, -117, -125, -132, -139, -147, -154,
    -161, -169, -176, -183, -190, -196, -202, -208,
    213, 218, 222, 225, 227, 228, 228, 227,
    224, 221, 215, 208, 200, 189, 177, 163,
    0, 127, 106, 83, 57, 29, -2, -36,
    -72, -111, -153, -197, -244, -294, -347, -401,
    -459, -519, -581, -645, -711, -779, -848, -919,
    -991, -1064, -1137, -1210, -1283, -1356, -1428, -1498,
    -1567, -1634, -1698, -1759, -1817, -1870, -1919, -1962,
    -2001, -2032, -2057, -2075, -2085, -2087, -2080, -2063,
    2037, 2000, 1952, 1893, 1822, 1739, 1644, 1535,
    1414, 1280, 1131, 970, 794, 605, 402, 185,
    0, -288, -545, -814, -1095, -1388, -1692, -2006,
    -2330, -2663, -3004, -3351, -3705, -4063, -4425, -4788,
    -5153, -5517, -5879, -6237, -6589, -6935, -7271, -7597,
    -7910, -8209, -8491, -8755, -8998, -9219, -9416, -9585,
    -9727, -9838, -9916, -9959, -9966, -9935, -9863, -9750,
    -9592, -9389, -9139, -8840, -8492, -8092, -7640, -7134,
    6574, 5959, 5288, 4561, 3776, 2935, 2037, 1082,
    70, -998, -2122, -3300, -4533, -5818, -7154, -8540,
    0, -11455, -12980, -14548, -16155, -17799, -19478, -21189,
    -22929, -24694, -26482, -28289, -30112, -31947, -33791, -35640,
    -37489, -39336, -41176, -43006, -44821, -46617, -48390, -50137,
    -51853, -53534, -55178, -56778, -58333, -59838, -61289, -62684,
    -64019, -65290, -66494, -67629, -68692, -69679, -70590, -71420,
    -72169, -72835, -73415, -73908, -74313, -74630, -74856, -74992,
    75038, 74992, 74856, 74630, 74313, 73908, 73415, 72835,
    72169, 71420, 70590, 69679, 68692, 67629, 66494, 65290,
    0, 62684, 61289, 59838, 58333, 56778, 55178, 53534,
    51853, 50137, 48390, 46617, 44821, 43006, 41176, 39336,
    37489, 35640, 33791, 31947, 30112, 28289, 26482, 24694,
    22929, 21189, 19478, 17799, 16155, 14548, 12980, 11455,
    9975, 8540, 7154, 5818, 4533, 3300, 2122, 998,
    -70, -1082, -2037, -2935, -3776, -4561, -5288, -5959,
    6574, 7134, 7640, 8092, 8492, 8840, 9139, 9389,
    9592, 9750, 9863, 9935, 9966, 9959, 9916, 9838,
    0, 9585, 9416, 9219, 8998, 8755, 8491, 8209,
    7910, 7597, 7271, 6935, 6589, 6237, 5879, 5517,
    5153, 4788, 4425, 4063, 3705, 3351, 3004, 2663,
    2330, 2006, 1692, 1388, 1095, 814, 545, 288,
    45, -185, -402, -605, -794, -970, -1131, -1280,
    -1414, -1535, -1644, -1739, -1822, -1893, -1952, -2000,
    2037, 2063, 2080, 2087, 2085, 2075, 2057, 2032,
    2001, 1962, 1919, 1870, 1817, 1759, 1698, 1634,
    0, 1498, 1428, 1356, 1283, 1210, 1137, 1064,
    991, 919, 848, 779, 711, 645, 581, 519,
    459, 401, 347, 294, 244, 197, 153, 111,
    72, 36, 2, -29, -57, -83, -106, -127,
    -146, -163, -177, -189, -200, -208, -215, -221,
    -224, -227, -228, -228, -227, -225, -222, -218,
    213, 208, 202, 196, 190, 183, 176, 169,
    161, 154, 147, 139, 132, 125, 117, 111,
    0, 97, 91, 85, 79, 73, 68, 63,
    58, 53, 49, 45, 41, 38, 35, 31,
    29, 26, 24, 21, 19, 17, 16, 14,
    13, 11, 10, 9, 8, 7, 7, 6,
    5, 5, 4, 4, 3, 3, 2, 2,
    2, 2, 1, 1, 1, 1, 1, 1,
], dtype=np.int64)

_DWIN_RAW = _D_Q16.astype(np.float64) / 65536.0
_N_IDX = np.arange(_TAPS, dtype=np.float64)
_I_IDX = np.arange(SUBBANDS, dtype=np.float64)[:, None]
# Synthesis matrixing N[k,i] = cos((16+k)(2i+1)pi/64), k = 0..63 (spec
# formula, not table data).
_K64 = np.arange(64, dtype=np.float64)[:, None]
_NMAT = np.cos((16.0 + _K64) * (2 * np.arange(SUBBANDS)[None, :] + 1) * np.pi / 64.0)
# The decoder below reproduces libmpg123's output exactly with unit gain.
_SYN_GAIN = 1.0

# Analysis bank: the matched (time-reversed) filters of the synthesis
# bank — the standard analysis/synthesis relationship for an (almost)
# paraunitary filterbank, so no separate analysis table is needed.
# F[band, 32r+j] = D[j+32r] * N[sel(r,j), band], sel = j (even r) or
# 32+j (odd r); the analysis matrix is F reversed in time, scaled below
# to unit passband gain + unit full-chain gain (ISO level convention, so
# streams from this encoder play at correct level everywhere).
_F = np.zeros((SUBBANDS, _TAPS))
for _r in range(16):
    _sel = slice(0, 32) if _r % 2 == 0 else slice(32, 64)
    _F[:, 32 * _r : 32 * _r + 32] = (
        _DWIN_RAW[32 * _r : 32 * _r + 32][None, :] * _NMAT[_sel, :].T
    )
_ANALYSIS = _F[:, ::-1].copy()


def _analyze(pcm: np.ndarray) -> np.ndarray:
    """float PCM [T*32] -> subband samples [T, 32] (ISO granule order)."""
    n = len(pcm)
    t = n // SUBBANDS
    pad = np.concatenate([pcm[::-1], np.zeros(_TAPS, dtype=np.float64)])
    wins = np.lib.stride_tricks.sliding_window_view(pad, _TAPS)
    starts = n - SUBBANDS * (np.arange(t) + 1)
    return wins[starts] @ _ANALYSIS.T


def _synthesize(sb: np.ndarray) -> np.ndarray:
    """Subband samples [T, 32] -> float PCM [T*32], ISO V/U/W flowchart
    vectorised over granules: out[32g+j] = sum_r D[j+32r] * V(g-r, sel),
    where sel = j for even r and 32+j for odd r."""
    t = sb.shape[0]
    vall = sb @ _NMAT.T  # [T, 64]
    vpad = np.concatenate([np.zeros((15, 64)), vall], axis=0)  # index g-r -> g-r+15
    out = np.zeros((t, SUBBANDS), dtype=np.float64)
    for r in range(16):
        dslice = _DWIN_RAW[32 * r : 32 * r + 32]  # D[j+32r], j=0..31
        sel = slice(0, 32) if r % 2 == 0 else slice(32, 64)
        out += dslice[None, :] * vpad[15 - r : 15 - r + t, sel]
    return (out * _SYN_GAIN).reshape(-1)


def _analysis_passband_gain() -> float:
    """Measured per-subband passband gain of the analysis bank (tone at
    the centre of subband 3) — the ISO convention is unit passband gain
    (full-scale input -> full-scale subband samples, the 2.0 max
    scalefactor giving 6 dB headroom)."""
    sr = 6400
    tone = np.sin(2 * np.pi * (3 + 0.5) / 64.0 * np.arange(sr))
    pad = np.concatenate([tone, np.zeros((-sr) % SUBBANDS)])
    sb = _analyze(pad)
    return float(np.abs(sb[:, 3]).max())


def _chain_gain() -> float:
    """Unit-gain calibration: measured analysis->synthesis passband gain
    correction for the full chain.  Deterministic; computed once."""
    fs = 6400
    n = np.arange(fs, dtype=np.float64)
    x = np.sin(2 * np.pi * 0.011 * n)  # in-band test tone
    y = _synthesize(_analyze(x))
    d = 481  # ISO filterbank delay
    return float(np.dot(y[d:], x[: len(y) - d]) / np.dot(y[d:], y[d:]))


# Fold all level calibration into the ANALYSIS side: the synthesis side
# must stay bit-compatible with ISO decoders (gain exactly 1), so the
# encoder normalises instead.
_ANALYSIS /= _analysis_passband_gain()
_ANALYSIS *= _chain_gain()


class _BitWriter:
    def __init__(self) -> None:
        self.buf = bytearray()
        self.acc = 0
        self.nbits = 0

    def write(self, value: int, bits: int) -> None:
        self.acc = (self.acc << bits) | (int(value) & ((1 << bits) - 1))
        self.nbits += bits
        while self.nbits >= 8:
            self.nbits -= 8
            self.buf.append((self.acc >> self.nbits) & 0xFF)
        self.acc &= (1 << self.nbits) - 1

    def pad_to(self, nbytes: int) -> bytes:
        if self.nbits:
            self.buf.append((self.acc << (8 - self.nbits)) & 0xFF)
            self.acc = 0
            self.nbits = 0
        self.buf.extend(b"\x00" * (nbytes - len(self.buf)))
        return bytes(self.buf)


class _BitReader:
    def __init__(self, data: bytes) -> None:
        self.data = data
        self.pos = 0

    def read(self, bits: int) -> int:
        out = 0
        for _ in range(bits):
            byte = self.data[self.pos >> 3]
            out = (out << 1) | ((byte >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return out


def _rate_indices(sample_rate: int) -> tuple[int, int, list[int]]:
    """-> (version_bits, samplerate_index, bitrate_table)."""
    if sample_rate in _RATES_V1:
        return 3, _RATES_V1.index(sample_rate), _BITRATES_V1_L1
    if sample_rate in _RATES_V2:
        return 2, _RATES_V2.index(sample_rate), _BITRATES_V2_L1
    raise UnsupportedFormatError(
        f"sample rate {sample_rate} not representable in MPEG Layer I "
        f"(supported: {_RATES_V1 + _RATES_V2})"
    )


def _allocate_bits(scf_idx: np.ndarray, budget: int) -> np.ndarray:
    """Greedy waterfilling: spend `budget` bits across the 32 bands.

    A band at nb bits (2..15) costs 6 (scf) + 12*nb on first grant and
    12 per extra bit; repeatedly lower the loudest residual noise
    scf * 2^-nb.
    """
    nb = np.zeros(SUBBANDS, dtype=np.int64)
    amp = _SCALEFACTORS[scf_idx]
    noise = amp.copy()
    while True:
        granted = False
        for band in np.argsort(-noise):
            if noise[band] <= 1e-12:
                break
            if nb[band] == 0:
                cost, new = 6 + 12 * 2, 2
            elif nb[band] < 15:
                cost, new = 12, nb[band] + 1
            else:
                continue
            if cost <= budget:
                nb[band] = new
                noise[band] = amp[band] * 2.0 ** (-float(new))
                budget -= cost
                granted = True
                break
        if not granted:
            return nb


# ---------------------------------------------------------------- Layer II
#
# Layer II codes the same 32 subbands in 1152-sample frames (36 granule
# rows = 12 triplets), with per-subband quantizer classes drawn from a
# bit-allocation table selected by (version, sample rate, bitrate): the
# MPEG-2 LSF table (sblimit 30) or the MPEG-1 tables B.2a–d.  The class
# structure, grouping widths, nbal layout, and the requantization law
# s = (2c - (steps-1))/steps were each verified against libmpg123 with
# crafted single-subband probe frames (the same oracle discipline as the
# filterbank window above) — any table error shows up as bitstream
# misalignment in tests/test_syscodec.py's cross-decoder SNR sweep.

# steps -> (grouped?, bits): grouped classes pack a triplet into one code
# c = s0 + steps*s1 + steps^2*s2.
_L2_CLASS: dict[int, tuple[bool, int]] = {
    3: (True, 5), 5: (True, 7), 7: (False, 3), 9: (True, 10),
    15: (False, 4), 31: (False, 5), 63: (False, 6), 127: (False, 7),
    255: (False, 8), 511: (False, 9), 1023: (False, 10), 2047: (False, 11),
    4095: (False, 12), 8191: (False, 13), 16383: (False, 14),
    32767: (False, 15), 65535: (False, 16),
}

_L2_STEPS_HI = [3, 7, 15, 31, 63, 127, 255, 511, 1023, 2047, 4095, 8191,
                16383, 65535]
_L2_STEPS_MID = [3, 5, 7, 9, 15, 31, 63, 127, 255, 511, 1023, 2047, 4095,
                 65535]
_L2_STEPS_LOW = [3, 5, 7, 9, 15, 31, 65535]
_L2_STEPS_TINY = [3, 5, 65535]
_L2_STEPS_CD_HI = [3, 5, 9, 15, 31, 63, 127, 255, 511, 1023, 2047, 4095,
                   8191, 16383, 32767]
_L2_STEPS_CD_LO = [3, 5, 9, 15, 31, 63, 127]
_L2_LSF_HI = [3, 5, 7, 9, 15, 31, 63, 127, 255, 511, 1023, 2047, 4095, 8191,
              16383]
_L2_LSF_MID = [3, 5, 9, 15, 31, 63, 127]
_L2_LSF_TINY = [3, 5, 9]

# Allocation tables: one steps-list per subband (alloc code 0 = silent;
# code k selects steps_list[k-1]); nbal per subband = bit width of the
# max code = len(list).bit_length().  Tables A/B were written from the
# spec's structure and verified bit-exact against libmpg123; the C/D and
# LSF rows were RECOVERED from libmpg123 with two-subband probe frames
# (a misremembered row shows up as total-misalignment, so the recovery
# is self-checking): C/D are sblimit 8/12 with nbal [4,4,3...] — not the
# nbal-4-everywhere shape one might guess — and the LSF mid/low rows
# carry 9 (grouped) where a first guess had 7.
_L2_TABLE_A = [_L2_STEPS_HI] * 3 + [_L2_STEPS_MID] * 8 + \
    [_L2_STEPS_LOW] * 12 + [_L2_STEPS_TINY] * 4  # B.2a, sblimit 27
_L2_TABLE_B = [_L2_STEPS_HI] * 3 + [_L2_STEPS_MID] * 8 + \
    [_L2_STEPS_LOW] * 12 + [_L2_STEPS_TINY] * 7  # B.2b, sblimit 30
_L2_TABLE_C = [_L2_STEPS_CD_HI] * 2 + [_L2_STEPS_CD_LO] * 6  # sblimit 8
_L2_TABLE_D = [_L2_STEPS_CD_HI] * 2 + [_L2_STEPS_CD_LO] * 10  # sblimit 12
_L2_TABLE_LSF = [_L2_LSF_HI] * 4 + [_L2_LSF_MID] * 7 + \
    [_L2_LSF_TINY] * 19  # 13818-3 LSF table, sblimit 30


def _l2_nbal(steps_list: list[int]) -> int:
    # bits to hold the max alloc code (= len of the list; 0 means silent)
    return int(len(steps_list)).bit_length()


def _l2_table(version_bits: int, sample_rate: int,
              bitrate_kbps: int, nch: int) -> list[list[int]]:
    """Bit-allocation table selection (ISO 11172-3 2-B.2 / 13818-3)."""
    if version_bits == 2:  # MPEG-2 LSF: single table
        return _L2_TABLE_LSF
    bpc = bitrate_kbps // nch
    if bpc <= 48:
        return _L2_TABLE_D if sample_rate == 32000 else _L2_TABLE_C
    if bpc <= 80:
        return _L2_TABLE_A
    return _L2_TABLE_A if sample_rate == 48000 else _L2_TABLE_B


def _l2_quantize(w: "_BitWriter", triplet: np.ndarray, steps: int) -> None:
    grouped, bits = _L2_CLASS[steps]
    codes = []
    for s in triplet:
        c = int(np.floor((s * steps + steps - 1) * 0.5 + 0.5))
        codes.append(max(0, min(steps - 1, c)))
    if grouped:
        w.write(codes[0] + steps * codes[1] + steps * steps * codes[2], bits)
    else:
        for c in codes:
            w.write(c, bits)


def encode_layer2(
    pcm: np.ndarray, sample_rate: int = 16000, bitrate_kbps: int = 64
) -> bytes:
    """Encode float/int16 mono PCM to an MPEG Layer II stream.

    Layer II reaches transparent quality at roughly half Layer I's
    bitrate (1152-sample frames, grouped quantizers, per-part
    scalefactors); used for ``.mp2`` output and as the second
    first-party MPEG layer.  scfsi=0 (3 scalefactors per subband) keeps
    the encoder simple at a small bitrate cost.
    """
    pcm = np.asarray(pcm)
    if pcm.ndim == 2:
        pcm = pcm.mean(axis=1)
    pcm = (pcm.astype(np.float64) / 32768.0 if pcm.dtype.kind in "iu"
           else pcm.astype(np.float64))
    version_bits, sr_idx, _ = _rate_indices(sample_rate)
    table = _BITRATES_V1_L2 if version_bits == 3 else _BITRATES_V2_L2
    if bitrate_kbps not in table[1:]:
        bitrate_kbps = min(table[1:], key=lambda b: abs(b - bitrate_kbps))
    br_idx = table.index(bitrate_kbps)
    alloc_table = _l2_table(version_bits, sample_rate, bitrate_kbps, 1)
    sblimit = len(alloc_table)
    nbals = [_l2_nbal(s) for s in alloc_table]

    samples_per_frame = SUBBANDS * 36
    pad = (-len(pcm)) % samples_per_frame
    if pad:
        pcm = np.concatenate([pcm, np.zeros(pad)])
    frames = _analyze(pcm).reshape(-1, 36, SUBBANDS)

    bytes_exact = 144 * bitrate_kbps * 1000 / sample_rate
    out = bytearray()
    frac = 0.0
    for frame in frames:
        nbytes = int(bytes_exact)
        frac += bytes_exact - nbytes
        padding = 0
        if frac >= 1.0:
            padding, frac = 1, frac - 1.0
        frame_bytes = nbytes + padding

        # per-part (3 x 12 samples) scalefactors
        part_max = np.abs(frame.reshape(3, 12, SUBBANDS)).max(axis=1)  # (3, SB)
        scf_idx = np.clip(
            np.searchsorted(-_SCALEFACTORS, -part_max, side="right") - 1, 0, 62
        )
        band_amp = _SCALEFACTORS[scf_idx].max(axis=0)  # (SB,)

        # greedy allocation over table classes: first grant costs scfsi
        # (2) + 3 scalefactors (18) + sample bits; upgrades cost the
        # sample-bit delta.
        budget = frame_bytes * 8 - 32 - sum(nbals)
        level = [0] * sblimit

        def _sample_bits(sb: int, lv: int) -> int:
            if lv == 0:
                return 0
            grouped, bits = _L2_CLASS[alloc_table[sb][lv - 1]]
            return 12 * bits if grouped else 36 * bits

        noise = band_amp[:sblimit].copy()
        while True:
            granted = False
            for sb in np.argsort(-noise):
                if noise[sb] <= 1e-12:
                    break
                lv = level[sb]
                if lv >= len(alloc_table[sb]):
                    continue
                cost = _sample_bits(sb, lv + 1) - _sample_bits(sb, lv)
                if lv == 0:
                    cost += 2 + 18
                if cost <= budget:
                    level[sb] = lv + 1
                    steps = alloc_table[sb][lv]
                    noise[sb] = band_amp[sb] / steps
                    budget -= cost
                    granted = True
                    break
            if not granted:
                break

        w = _BitWriter()
        w.write(0x7FF, 11)
        w.write(version_bits, 2)
        w.write(0b10, 2)  # Layer II
        w.write(1, 1)  # no CRC
        w.write(br_idx, 4)
        w.write(sr_idx, 2)
        w.write(padding, 1)
        w.write(0, 1)
        w.write(0b11, 2)  # mono
        w.write(0, 2)
        w.write(0, 1)
        w.write(1, 1)
        w.write(0, 2)
        for sb in range(sblimit):
            w.write(level[sb], nbals[sb])
        for sb in range(sblimit):
            if level[sb]:
                w.write(0, 2)  # scfsi = 0: three scalefactors
        for sb in range(sblimit):
            if level[sb]:
                for p in range(3):
                    w.write(int(scf_idx[p, sb]), 6)
        sf = _SCALEFACTORS[scf_idx]  # (3, SB)
        for tri in range(12):
            part = tri // 4
            for sb in range(sblimit):
                if level[sb]:
                    steps = alloc_table[sb][level[sb] - 1]
                    triplet = frame[3 * tri : 3 * tri + 3, sb] / sf[part, sb]
                    _l2_quantize(w, triplet, steps)
        out.extend(w.pad_to(frame_bytes))
    return bytes(out)


def encode_layer1(
    pcm: np.ndarray, sample_rate: int = 16000, bitrate_kbps: int = 128
) -> bytes:
    """Encode float/int16 mono PCM to an MPEG Layer I stream.

    Replaces the reference's ffmpeg mp3 encode for sample extraction
    (speaker_samples:280-326).
    """
    pcm = np.asarray(pcm)
    if pcm.ndim == 2:
        pcm = pcm.mean(axis=1)
    if pcm.dtype.kind in "iu":
        pcm = pcm.astype(np.float64) / 32768.0
    else:
        pcm = pcm.astype(np.float64)
    version_bits, sr_idx, table = _rate_indices(sample_rate)
    if bitrate_kbps not in table[1:]:
        bitrate_kbps = min(table[1:], key=lambda b: abs(b - bitrate_kbps))
    br_idx = table.index(bitrate_kbps)

    pad = (-len(pcm)) % FRAME_SAMPLES
    if pad:
        pcm = np.concatenate([pcm, np.zeros(pad)])
    frames = _analyze(pcm).reshape(-1, GRANULES, SUBBANDS)

    slots_exact = 12 * bitrate_kbps * 1000 / sample_rate
    out = bytearray()
    slot_frac = 0.0
    for frame in frames:
        slots = int(slots_exact)
        slot_frac += slots_exact - slots
        padding = 0
        if slot_frac >= 1.0:
            padding, slot_frac = 1, slot_frac - 1.0
        frame_bytes = (slots + padding) * 4

        bandmax = np.abs(frame).max(axis=0)
        # smallest scalefactor >= bandmax (_SCALEFACTORS is descending)
        scf_idx = np.clip(
            np.searchsorted(-_SCALEFACTORS, -bandmax, side="right") - 1, 0, 62
        )

        budget = frame_bytes * 8 - 32 - SUBBANDS * 4
        nb = _allocate_bits(scf_idx, budget)

        w = _BitWriter()
        w.write(0x7FF, 11)
        w.write(version_bits, 2)
        w.write(0b11, 2)  # Layer I
        w.write(1, 1)  # no CRC
        w.write(br_idx, 4)
        w.write(sr_idx, 2)
        w.write(padding, 1)
        w.write(0, 1)  # private
        w.write(0b11, 2)  # mono
        w.write(0, 2)  # mode extension
        w.write(0, 1)  # copyright
        w.write(1, 1)  # original
        w.write(0, 2)  # no emphasis
        for b in range(SUBBANDS):
            w.write(nb[b] - 1 if nb[b] else 0, 4)
        active = [b for b in range(SUBBANDS) if nb[b]]
        for b in active:
            w.write(int(scf_idx[b]), 6)
        sf = _SCALEFACTORS[scf_idx]
        for g in range(GRANULES):
            for b in active:
                # ISO Layer I dequant is s = (2c - (2^nb - 2)) / (2^nb - 1)
                # (verified against libmpg123's measured mapping); invert
                # it for the nearest code.
                bits = int(nb[b])
                levels = (1 << bits) - 1
                sn = frame[g, b] / sf[b]
                code = int(np.floor((sn * levels + levels - 1) * 0.5 + 0.5))
                w.write(max(0, min(levels, code)), bits)
        out.extend(w.pad_to(frame_bytes))
    return bytes(out)


def _decode_body_layer1(r: "_BitReader", nch: int) -> np.ndarray:
    """Layer I frame body -> mono-mixed subband samples (12, 32)."""
    alloc = np.zeros((nch, SUBBANDS), dtype=np.int64)
    for b in range(SUBBANDS):
        for ch in range(nch):
            code = r.read(4)
            alloc[ch, b] = code + 1 if code else 0
    scf = np.zeros((nch, SUBBANDS), dtype=np.int64)
    for b in range(SUBBANDS):
        for ch in range(nch):
            if alloc[ch, b]:
                scf[ch, b] = r.read(6)
    sbf = np.zeros((GRANULES, SUBBANDS), dtype=np.float64)
    for g in range(GRANULES):
        for b in range(SUBBANDS):
            acc = 0.0
            for ch in range(nch):
                nb = int(alloc[ch, b])
                if nb:
                    levels = (1 << nb) - 1
                    code = r.read(nb)
                    # ISO requantization (same mapping libmpg123 uses)
                    sn = (2.0 * code - (levels - 1)) / levels
                    acc += sn * _SCALEFACTORS[min(62, int(scf[ch, b]))]
            sbf[g, b] = acc / nch
    return sbf


def _decode_body_layer2(
    r: "_BitReader", nch: int, version_bits: int, rate: int, bitrate_kbps: int
) -> np.ndarray:
    """Layer II frame body -> mono-mixed subband samples (36, 32)."""
    alloc_table = _l2_table(version_bits, rate, bitrate_kbps, nch)
    sblimit = len(alloc_table)
    steps_sel = np.zeros((nch, sblimit), dtype=np.int64)
    for sb in range(sblimit):
        nbal = _l2_nbal(alloc_table[sb])
        for ch in range(nch):
            code = r.read(nbal)
            if code > len(alloc_table[sb]):
                raise UnsupportedFormatError(
                    f"invalid Layer II allocation code {code} in subband {sb}"
                )
            steps_sel[ch, sb] = alloc_table[sb][code - 1] if code else 0
    scfsi = np.zeros((nch, sblimit), dtype=np.int64)
    for sb in range(sblimit):
        for ch in range(nch):
            if steps_sel[ch, sb]:
                scfsi[ch, sb] = r.read(2)
    # scalefactors per part under the scfsi sharing patterns
    scf = np.zeros((nch, sblimit, 3), dtype=np.int64)
    for sb in range(sblimit):
        for ch in range(nch):
            if not steps_sel[ch, sb]:
                continue
            si = int(scfsi[ch, sb])
            if si == 0:
                vals = [r.read(6) for _ in range(3)]
            elif si == 1:
                a, b = r.read(6), r.read(6)
                vals = [a, a, b]
            elif si == 2:
                a = r.read(6)
                vals = [a, a, a]
            else:
                a, b = r.read(6), r.read(6)
                vals = [a, b, b]
            scf[ch, sb] = vals
    sbf = np.zeros((36, SUBBANDS), dtype=np.float64)
    for tri in range(12):
        part = tri // 4
        for sb in range(sblimit):
            for ch in range(nch):
                steps = int(steps_sel[ch, sb])
                if not steps:
                    continue
                grouped, bits = _L2_CLASS[steps]
                if grouped:
                    c = r.read(bits)
                    codes = (c % steps, (c // steps) % steps,
                             (c // (steps * steps)) % steps)
                else:
                    codes = (r.read(bits), r.read(bits), r.read(bits))
                amp = _SCALEFACTORS[min(62, int(scf[ch, sb, part]))]
                for k in range(3):
                    sn = (2.0 * codes[k] - (steps - 1)) / steps
                    sbf[3 * tri + k, sb] += sn * amp / nch
    return sbf


def decode(data: bytes) -> tuple[np.ndarray, int]:
    """Decode an MPEG Layer I/II stream -> (float64 mono PCM, rate).

    Layer III streams raise UnsupportedFormatError with an explicit
    reason (the system codec in utils/syscodec.py handles them when
    libmpg123 is present; see module docstring).
    """
    pos = 0
    if data[:3] == b"ID3" and len(data) > 10:
        size = (
            (data[6] & 0x7F) << 21
            | (data[7] & 0x7F) << 14
            | (data[8] & 0x7F) << 7
            | (data[9] & 0x7F)
        )
        pos = 10 + size
    sb_frames: list[np.ndarray] = []
    sample_rate = None
    while pos + 4 <= len(data):
        if data[pos] != 0xFF or (data[pos + 1] & 0xE0) != 0xE0:
            pos += 1  # resync
            continue
        b1, b2 = data[pos + 1], data[pos + 2]
        version_bits = (b1 >> 3) & 0x3
        layer_bits = (b1 >> 1) & 0x3
        if layer_bits == 0b01:
            raise UnsupportedFormatError(
                "MPEG Layer III stream: the first-party codec decodes "
                "Layers I/II (Layer III needs the spec's Huffman tables); "
                "install libmpg123 for in-process Layer III decode, or "
                "transcode to WAV/FLAC"
            )
        if layer_bits == 0b00:
            raise UnsupportedFormatError("reserved MPEG layer in header")
        layer2 = layer_bits == 0b10
        br_idx = (b2 >> 4) & 0xF
        sr_idx = (b2 >> 2) & 0x3
        padding = (b2 >> 1) & 0x1
        mode = (data[pos + 3] >> 6) & 0x3
        if version_bits == 3:
            rate = _RATES_V1[sr_idx] if sr_idx < 3 else 0
            table = _BITRATES_V1_L2 if layer2 else _BITRATES_V1_L1
        elif version_bits == 2:
            rate = _RATES_V2[sr_idx] if sr_idx < 3 else 0
            table = _BITRATES_V2_L2 if layer2 else _BITRATES_V2_L1
        else:
            raise UnsupportedFormatError("MPEG version 2.5 not supported")
        if br_idx in (0, 15) or sr_idx == 3:
            raise UnsupportedFormatError("free-format/invalid MPEG header")
        sample_rate = rate
        bitrate = table[br_idx] * 1000
        if layer2:
            frame_bytes = 144 * bitrate // rate + padding
        else:
            frame_bytes = (12 * bitrate // rate + padding) * 4
        frame = data[pos : pos + frame_bytes]
        if len(frame) < frame_bytes:
            break
        if layer2 and mode == 0b01:
            raise UnsupportedFormatError(
                "Layer II joint (intensity) stereo not supported by the "
                "first-party codec; install libmpg123"
            )
        nch = 1 if mode == 0b11 else 2
        r = _BitReader(frame)
        r.read(32)
        if not (b1 & 1):  # protection bit 0 -> CRC present
            r.read(16)
        if layer2:
            sb_frames.append(
                _decode_body_layer2(r, nch, version_bits, rate, table[br_idx])
            )
        else:
            sb_frames.append(_decode_body_layer1(r, nch))
        pos += frame_bytes
    if not sb_frames or not sample_rate:
        raise UnsupportedFormatError("no MPEG Layer I/II frames found")
    pcm = _synthesize(np.concatenate(sb_frames, axis=0))
    return np.clip(pcm, -1.0, 1.0), sample_rate
