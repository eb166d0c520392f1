"""The port's own BGZF inflate: ``inflate_block`` in libpancov_io, through
its test entry ``pancov_inflate_raw``, held to Python's zlib (raw DEFLATE,
``wbits=-15``) as the yardstick.

- Byte-equal on every block of a benchmark-shaped BAM
  (``portbench.inputs.synth``'s ``capsicum_chr`` reads) and of a
  literal-heavy one (``synth.literal_bam``), at zlib's levels 0-9 under
  each strategy, and on streams written here bit by bit (``_Bits``) for
  the format's edges: empty and 1-byte outputs, a 65,536-byte one,
  distances 1 to 32,768, length 258, stored blocks among Huffman ones, and
  matches that end on either side of the decoder's fast-loop margin.
- The same verdict as zlib on seeded mutations and truncations of such
  streams, and on hand-made streams that break one of its rules: where
  zlib inflates a stream to exactly the expected length, the decoder
  yields the same bytes; where zlib fails, the decoder fails. An expected
  length one short or one long fails.
- ``NativeBamStream.inflate_seconds`` (the run's ``feed.inflate``) counts
  the time of every walk.

Each stream is handed to the decoder with 8 bytes after it, as the BGZF
trailer follows every payload in the stream's buffers.
"""

import ctypes
import json
import os
import random
import struct
import time
import zlib

import pytest

from pandepth_tpu_torch import synth
from pandepth_tpu_torch.io.bamindex import load_index_for, record_starts
from pandepth_tpu_torch.io.bgzf import iter_block_ranges
from pandepth_tpu_torch.io.native import NativeBamStream, load_library

_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")

LEN_BASE = [3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31, 35,
            43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258]
LEN_EXTRA = [0] * 8 + [1] * 4 + [2] * 4 + [3] * 4 + [4] * 4 + [5] * 4 + [0]
DIST_BASE = [1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193,
             257, 385, 513, 769, 1025, 1537, 2049, 3073, 4097, 6145, 8193,
             12289, 16385, 24577]
DIST_EXTRA = [0, 0, 0, 0] + [k // 2 for k in range(2, 28)]
PRECODE_ORDER = [16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2,
                 14, 1, 15]
FIXED_LIT = [8] * 144 + [9] * 112 + [7] * 24 + [8] * 8
# a complete precode over all 19 symbols
PRECODE = [4] * 13 + [5] * 6
STRATEGIES = [zlib.Z_DEFAULT_STRATEGY, zlib.Z_FILTERED, zlib.Z_HUFFMAN_ONLY,
              zlib.Z_RLE, zlib.Z_FIXED]


@pytest.fixture(scope="module")
def lib():
    lib = load_library()
    if lib is None:
        pytest.skip("libpancov_io does not build here")
    return lib


def ours(lib, payload: bytes, n: int):
    """The decoder's output of exactly n bytes, or None where it fails."""
    src = ctypes.create_string_buffer(payload + b"\x5a" * 8, len(payload) + 8)
    dst = ctypes.create_string_buffer(max(n, 1))
    ok = lib.pancov_inflate_raw(ctypes.addressof(src), len(payload),
                                ctypes.addressof(dst), n)
    return dst.raw[:n] if ok else None


def theirs(payload: bytes, n: int):
    """zlib's raw inflate into n bytes: the output where the stream ends
    with exactly n bytes out, else None."""
    d = zlib.decompressobj(-15)
    try:
        out = d.decompress(payload, n + 1)
    except zlib.error:
        return None
    return out if d.eof and len(out) == n else None


def deflate(data: bytes, level: int = 6, strategy: int = 0) -> bytes:
    c = zlib.compressobj(level, zlib.DEFLATED, -15, 9, strategy)
    return c.compress(data) + c.flush()


class _Bits:
    """A DEFLATE bit stream written by hand: fields least significant bit
    first, Huffman codewords most significant bit first."""

    def __init__(self):
        self.acc = self.n = 0
        self.out = bytearray()

    def put(self, v: int, n: int):
        self.acc |= (v & ((1 << n) - 1)) << self.n
        self.n += n
        while self.n >= 8:
            self.out.append(self.acc & 0xFF)
            self.acc >>= 8
            self.n -= 8

    def code(self, cw):
        v, n = cw
        self.put(int(format(v, f"0{n}b")[::-1], 2) if n else 0, n)

    def align(self):
        if self.n:
            self.put(0, 8 - self.n)

    def bytes(self) -> bytes:
        return bytes(self.out) + (bytes([self.acc]) if self.n else b"")


def canonical(lens):
    """RFC 1951 3.2.2: symbol -> (codeword, length)."""
    count = [0] * 16
    for ln in lens:
        count[ln] += 1
    count[0] = 0
    code, nxt = 0, [0] * 16
    for b in range(1, 16):
        code = (code + count[b - 1]) << 1
        nxt[b] = code
    out = {}
    for s, ln in enumerate(lens):
        if ln:
            out[s] = (nxt[ln], ln)
            nxt[ln] += 1
    return out


def _symbols(bw, items, lit, dist):
    """Write items: a literal byte (int), a match (length, distance),
    ("sym", s) a litlen symbol without extra bits, ("dsym", s) a length
    of 3 then distance symbol s without extra bits, ("bits", v, n) raw
    bits; then the end of the block."""
    for it in items:
        if isinstance(it, int):
            bw.code(lit[it])
        elif it[0] == "sym":
            bw.code(lit[it[1]])
        elif it[0] == "dsym":
            bw.code(lit[257])
            bw.code(dist[it[1]])
        elif it[0] == "bits":
            bw.put(it[1], it[2])
        else:
            length, d = it
            i = 28 if length == 258 else max(
                k for k in range(28) if LEN_BASE[k] <= length)
            bw.code(lit[257 + i])
            bw.put(length - LEN_BASE[i], LEN_EXTRA[i])
            j = max(k for k in range(30) if DIST_BASE[k] <= d)
            bw.code(dist[j])
            bw.put(d - DIST_BASE[j], DIST_EXTRA[j])
    if 256 in lit:
        bw.code(lit[256])


def fixed_block(bw, items, final=True):
    bw.put(final, 1)
    bw.put(1, 2)
    _symbols(bw, items, canonical(FIXED_LIT), canonical([5] * 32))


def dynamic_block(bw, lit_lens, dist_lens, items, final=True, seq=None,
                  precode=PRECODE):
    """A dynamic block: the code lengths sent as ``seq`` ((precode
    symbol, extra) pairs; by default each length as itself) under
    ``precode``."""
    bw.put(final, 1)
    bw.put(2, 2)
    bw.put(len(lit_lens) - 257, 5)
    bw.put(len(dist_lens) - 1, 5)
    bw.put(15, 4)
    for s in PRECODE_ORDER:
        bw.put(precode[s], 3)
    pc = canonical(precode)
    extra = {16: 2, 17: 3, 18: 7}
    for s, x in seq if seq is not None else \
            [(ln, 0) for ln in list(lit_lens) + list(dist_lens)]:
        bw.code(pc[s])
        if s in extra:
            bw.put(x, extra[s])
    _symbols(bw, items, canonical(lit_lens), canonical(dist_lens))


def stored_block(bw, data, final=True, nlen=None):
    bw.put(final, 1)
    bw.put(0, 2)
    bw.align()
    bw.put(len(data), 16)
    bw.put((~len(data) & 0xFFFF) if nlen is None else nlen, 16)
    for b in data:
        bw.put(b, 8)


def written(*blocks) -> bytes:
    bw = _Bits()
    for fn, args, kw in blocks:
        fn(bw, *args, **kw)
    return bw.bytes()


def expand(items) -> bytes:
    out = bytearray()
    for it in items:
        if isinstance(it, int):
            out.append(it)
        else:
            length, d = it
            for _ in range(length):
                out.append(out[-d])
    return bytes(out)


def bgzf_blocks(path):
    """(payload, ISIZE) of every non-empty BGZF block of ``path``."""
    with open(path, "rb") as fh:
        data = fh.read()
    out = []
    for off, bsize, payload in iter_block_ranges(data):
        isize = struct.unpack_from("<I", data, off + bsize - 4)[0]
        if isize:
            out.append((data[payload: off + bsize - 8], isize))
    return out


@pytest.fixture(scope="module")
def bams(tmp_path_factory):
    """A ``capsicum_chr``-shaped sample of the benchmark's generator, cut
    to 60,000 reads, and a literal-heavy BAM."""
    from portbench.inputs import synth as bench_synth

    d = tmp_path_factory.mktemp("inflate")
    with open(os.path.join(_ROOT, "portbench", "configs",
                           "capsicum_chr.json")) as fh:
        cfg = json.load(fh)
    cfg["reads_per_sample"] = 60_000
    chr_bam = str(d / "chr.bam")
    bench_synth.write_bam(chr_bam, cfg,
                          bench_synth.make_reads(cfg, 2_147_483_659))
    lit_bam = str(d / "literal.bam")
    synth.literal_bam(lit_bam, 12_000, seed=7)
    return {"chr": chr_bam, "literal": lit_bam}


@pytest.mark.parametrize("kind", ["chr", "literal"])
def test_every_bam_block(lib, bams, kind):
    blocks = bgzf_blocks(bams[kind])
    assert len(blocks) > 30
    for payload, isize in blocks:
        assert ours(lib, payload, isize) == zlib.decompress(payload, -15)


def _this_file() -> bytes:
    with open(__file__, "rb") as fh:
        return fh.read()


def _corpus(bams):
    """Outputs of several shapes: a chr block's, a literal-heavy block's,
    text, random bytes, runs."""
    rng = random.Random(3)
    chr_pl = bgzf_blocks(bams["chr"])[3][0]
    lit_pl = bgzf_blocks(bams["literal"])[3][0]
    return [zlib.decompress(chr_pl, -15),
            zlib.decompress(lit_pl, -15)[:16_000],
            _this_file(),
            bytes(rng.getrandbits(8) for _ in range(8_000)),
            b"\xff" * 3000 + b"=" * 5 + b"\x00" * 20_000]


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("level", range(10))
def test_levels_and_strategies(lib, bams, level, strategy):
    for data in _corpus(bams):
        assert ours(lib, deflate(data, level, strategy), len(data)) == data


def _distance_items(d):
    """A match at distance d: d random literals, then one of length 258
    and one of length 3."""
    rng = random.Random(d)
    return [rng.getrandbits(8) for _ in range(d)] + [(258, d), (3, d)]


def _margin_items(d, k):
    """A 600-byte output whose match of 258 bytes at distance d ends k
    bytes before the end, after random literals and before k more: as k
    runs over 0-40 the match starts on both sides of the fast loop's
    margin of 258 + 16 bytes, so an over-copy past the margin shows. The
    streams below end in 32 bytes that are not read, so that the input's
    margin does not end the fast loop first."""
    rng = random.Random(d * 100 + k)
    return [rng.getrandbits(8) for _ in range(600 - 258 - k)] + \
        [(258, d)] + [rng.getrandbits(8) for _ in range(k)]


MARGIN_DISTANCES = (1, 2, 3, 7, 8, 15, 16, 17, 300)
MARGIN_STREAMS = {d: [written((fixed_block, (_margin_items(d, k),), {}))
                      + bytes(32) for k in range(41)]
                  for d in MARGIN_DISTANCES}


EDGES = {
    "empty_fixed": [(fixed_block, ([],), {})],
    "empty_stored": [(stored_block, (b"",), {})],
    "one_byte": [(fixed_block, ([65],), {})],
    "one_byte_stored": [(stored_block, (b"A",), {})],
    "full_64k": [(stored_block, (bytes(range(256)) * 255,), {"final": False}),
                 (fixed_block, ([1, 2, 3, (200, 1000), (53, 32768)],), {})],
    "mixed_blocks": [(stored_block, (b"abc" * 50,), {"final": False}),
                     (fixed_block, ([120, (100, 1), (258, 150)],),
                      {"final": False}),
                     (stored_block, (b"",), {"final": False}),
                     (fixed_block, ([(258, 17)],), {})],
}
for _d in list(range(1, 33)) + [63, 64, 65, 255, 256, 257, 1000, 4096,
                                8191, 16384, 24577, 32767, 32768]:
    EDGES[f"distance_{_d}"] = [(fixed_block, (_distance_items(_d),), {})]


@pytest.mark.parametrize("name", sorted(EDGES))
def test_edges(lib, name):
    payload = written(*EDGES[name])
    want = zlib.decompress(payload, -15)
    assert ours(lib, payload, len(want)) == want
    if name == "full_64k":
        assert len(want) == 65536
    if name.startswith("distance"):
        assert want == expand(EDGES[name][0][1][0])


@pytest.mark.parametrize("d", MARGIN_DISTANCES)
def test_fast_loop_margin(lib, d):
    for k, payload in enumerate(MARGIN_STREAMS[d]):
        want = expand(_margin_items(d, k))
        assert theirs(payload, 600) == want
        assert ours(lib, payload, 600) == want


def _lens(pairs, n):
    lens = [0] * n
    for s, ln in pairs:
        lens[s] = ln
    return lens


LIT_AB = _lens([(65, 2), (66, 2), (256, 2), (257, 2)], 258)  # A B EOB len3
DIST_2 = _lens([(0, 1), (1, 1)], 2)

# one rule of zlib's a stream: (blocks, expected length, zlib's verdict)
RULES = {
    "block_type_3": (lambda bw: (bw.put(1, 1), bw.put(3, 2), bw.put(0, 16)),
                     0, False),
    "stored_nlen": ([(stored_block, (b"xy",), {"nlen": 0x1234})], 2, False),
    "stored_cut": (("cut", [(stored_block, (b"xyz" * 20,), {})]), 60,
                   False),
    "fixed_286": ([(fixed_block, ([("sym", 286)],), {})], 0, False),
    "fixed_287": ([(fixed_block, ([("sym", 287)],), {})], 0, False),
    "fixed_dist_30": ([(fixed_block, ([65, ("dsym", 30)],), {})], 4, False),
    "fixed_dist_31": ([(fixed_block, ([65, ("dsym", 31)],), {})], 4, False),
    "too_far_back": ([(fixed_block, ([65, (3, 2)],), {})], 4, False),
    "dynamic_ok": ([(dynamic_block, (LIT_AB, DIST_2,
                                     [65, 66, (3, 2), (3, 1)]), {})],
                   8, True),
    "repeat_first": ([(dynamic_block, (LIT_AB, DIST_2, [65]),
                       {"seq": [(16, 0)]})], 1, False),
    "repeat_past_end": ([(dynamic_block, (LIT_AB, DIST_2, [65]), {
        "seq": [(0, 0)] * 65 + [(2, 0), (2, 0)] + [(18, 127)] * 2})],
        1, False),
    # a repeat of the last litlen length into the distance lengths
    "repeat_across": ([(dynamic_block, (
        _lens([(65, 1), (256, 2), (257, 2)], 258), [2, 2, 2, 2],
        [65, (3, 1)]), {"seq": [(18, 65 - 11), (1, 0), (18, 138 - 11),
                                (18, 52 - 11), (2, 0), (16, 0), (2, 0),
                                (2, 0)]})], 4, True),
    "oversubscribed": ([(dynamic_block, (_lens([(65, 1), (66, 1),
                                                (256, 1)], 257),
                                         DIST_2, [65]), {})], 1, False),
    "incomplete": ([(dynamic_block, (_lens([(65, 2), (256, 2)], 257),
                                     DIST_2, [65]), {})], 1, False),
    "only_eob": ([(dynamic_block, (_lens([(256, 1)], 257), DIST_2, []),
                   {})], 0, True),
    "only_eob_unused_code": ([(dynamic_block, (_lens([(256, 1)], 257),
                                               DIST_2, [("bits", 1, 1)]),
                               {})], 0, False),
    "no_eob": ([(dynamic_block, (_lens([(65, 1), (66, 1)], 257), DIST_2,
                                 []), {})], 0, False),
    "no_distances_unused": ([(dynamic_block, (LIT_AB, [0], [65, 66]),
                              {})], 2, True),
    "no_distances_used": ([(dynamic_block, (
        LIT_AB, [0], [65, ("sym", 257), ("bits", 0, 1)]), {})], 4, False),
    "one_distance": ([(dynamic_block, (LIT_AB, [1], [65, (3, 1)]), {})],
                     4, True),
    "one_distance_unused_code": ([(dynamic_block, (
        LIT_AB, [1], [65, ("sym", 257), ("bits", 1, 1)]), {})], 4, False),
    "incomplete_distances": ([(dynamic_block, (LIT_AB, [2, 0, 2],
                                               [65, (3, 1)]), {})],
                             4, False),
    "hlit_287": ([(dynamic_block, (LIT_AB + [0] * 29, DIST_2, [65]), {})],
                 1, False),
    "hdist_31": ([(dynamic_block, (LIT_AB, DIST_2 + [0] * 29, [65]), {})],
                 1, False),
    "precode_incomplete": ([(dynamic_block, (LIT_AB, DIST_2, [65]),
                             {"precode": [0, 2, 2] + [0] * 16,
                              "seq": []})], 1, False),
    "short_of_isize": ([(fixed_block, ([65, 66],), {})], 3, False),
    "past_isize": ([(fixed_block, ([65, 66, (10, 1)],), {})], 11, False),
    "input_cut": (("cut", [(fixed_block, ([65] * 40,), {})]), 40, False),
    "trailing_input": (("tail", [(fixed_block, ([65, (8, 1)],), {})]), 9,
                       True),
    "not_final": ([(fixed_block, ([65],), {"final": False})], 1, False),
}


def _rule_payload(spec):
    if callable(spec):
        bw = _Bits()
        spec(bw)
        return bw.bytes()
    if spec[0] == "cut":
        p = written(*spec[1])
        return p[:len(p) - 2]
    if spec[0] == "tail":
        return written(*spec[1]) + b"\x03\x00garbage"
    return written(*spec)


@pytest.mark.parametrize("name", sorted(RULES))
def test_rules(lib, name):
    spec, n, ok = RULES[name]
    payload = _rule_payload(spec)
    want = theirs(payload, n)
    assert (want is not None) == ok, name  # zlib's verdict, as described
    assert ours(lib, payload, n) == want


def _mutants(rng, payload):
    """A seeded mutation of ``payload``: bit flips, a byte set, deleted
    or inserted, a truncation, or a splice, half of them in its first 64
    bytes (the block headers)."""
    p = bytearray(payload)
    at = lambda: rng.randrange(min(len(p), 64)) if rng.random() < 0.5 \
        else rng.randrange(len(p))  # noqa: E731
    kind = rng.randrange(6)
    if kind == 0:
        for _ in range(rng.randrange(1, 4)):
            p[at()] ^= 1 << rng.randrange(8)
    elif kind == 1:
        p[at()] = rng.getrandbits(8)
    elif kind == 2:
        del p[at()]
    elif kind == 3:
        p.insert(at(), rng.getrandbits(8))
    elif kind == 4:
        del p[rng.randrange(len(p) + 1):]
    else:
        i, j = sorted(rng.randrange(len(p) + 1) for _ in range(2))
        p[i:j] = bytes(rng.getrandbits(8) for _ in range(j - i))
    return bytes(p)


def _mutation_bases(bams):
    rng = random.Random(11)
    chr_pl, chr_n = bgzf_blocks(bams["chr"])[5]
    chr_data = zlib.decompress(chr_pl, -15)
    bases = [(chr_pl, chr_n)]
    for data in (chr_data[:4000], _this_file()[:3000],
                 bytes(rng.choice(b"ACGT") for _ in range(2000)),
                 b"\xff" * 900 + bytes(range(60))):
        for level, strategy in ((1, 0), (6, 0), (9, zlib.Z_FILTERED),
                                (6, zlib.Z_HUFFMAN_ONLY), (6, zlib.Z_RLE),
                                (6, zlib.Z_FIXED), (0, 0)):
            bases.append((deflate(data, level, strategy), len(data)))
    for blocks in (EDGES["mixed_blocks"], EDGES["distance_7"],
                   RULES["dynamic_ok"][0], RULES["repeat_across"][0]):
        payload = written(*blocks)
        bases.append((payload, len(zlib.decompress(payload, -15))))
    return bases


@pytest.mark.parametrize("seed", range(10))
def test_mutations_match_zlib(lib, bams, seed):
    """1,000 mutations a seed: the decoder's verdict is zlib's, and where
    both inflate, the bytes are equal."""
    rng = random.Random(1000 + seed)
    bases = _mutation_bases(bams)
    agree_ok = 0
    for _ in range(1000):
        payload, n = rng.choice(bases)
        m = _mutants(rng, payload)
        want = theirs(m, n)
        assert ours(lib, m, n) == want, (seed, m[:64].hex(), n)
        agree_ok += want is not None
    # both verdicts occur: the mutations reach past the headers
    assert 20 < agree_ok < 980


@pytest.mark.parametrize("delta", [-1, 1])
def test_wrong_length_fails(lib, bams, delta):
    for data in _corpus(bams):
        payload = deflate(data)
        assert ours(lib, payload, len(data) + delta) is None
        assert theirs(payload, len(data) + delta) is None


@pytest.mark.parametrize("walk", ["serial", "split"])
def test_stream_counts_its_inflate(lib, bams, walk):
    """Every walk counts the seconds its threads spent inflating: more
    than none, less than its wall on each of its threads."""
    path = bams["chr"]
    cuts = None if walk == "serial" else record_starts(load_index_for(path))
    t0 = time.perf_counter()
    r = NativeBamStream(path, 1796, 0, threads=3, cuts=cuts,
                        window_bytes=1 << 20)
    while r.take_enc_acc(1 << 16, 1 << 12) is not None:
        pass
    wall = time.perf_counter() - t0
    got = r.inflate_seconds()
    assert r.split_share() == (1.0 if walk == "split" else 0.0)
    r.close()
    assert 0.0 < got < 3 * wall
