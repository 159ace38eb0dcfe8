"""The port's CUDA kernels against their plain PyTorch versions on the card,
and the device Reader against the CPU one.  Imports no JAX, so it runs on a
GPU machine without it:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Every test skips on a machine without a CUDA device.
"""

import collections

import numpy as np
import pytest
import torch

import pysubstringsearch_tpu_torch as pss
from pysubstringsearch_tpu_torch import sort_bench
from pysubstringsearch_tpu_torch.container import Chunk, read_container
from pysubstringsearch_tpu_torch.models.index import DeviceIndex
from pysubstringsearch_tpu_torch.ops import kernels
from pysubstringsearch_tpu_torch.ops import search as S
from pysubstringsearch_tpu_torch.ops import suffix_array as SA
from pysubstringsearch_tpu_torch.ops.native import suffix_array_native
from pysubstringsearch_tpu_torch.parallel.reader import ShardedIndex
from pysubstringsearch_tpu_torch.ops.suffix_array import (
    _pad_len,
    suffix_array_numpy,
)

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device and nvcc')
    return torch.device('cuda')


def _body(kind: str, size: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    lo, hi = {'ranked': (97, 123), 'ranked6': (50, 108),
              'nul': (97, 115), 'raw': (1, 256)}[kind]
    body = rng.integers(lo, hi, size=size, dtype=np.uint8)
    if kind == 'nul':
        body[::89] = 0
    body[::43] = 0x0A
    body[-1] = 0x0A
    return body


def _patterns(bodies, seed, count=400):
    rng = np.random.default_rng(seed)
    pats = [b'', b'\n', b'a', b'\xfe', b'zq\x00', b'\x01\x02\x03\x04\x05']
    for _ in range(count):
        body = bodies[int(rng.integers(0, len(bodies)))]
        l = int(rng.integers(1, 70))
        i = int(rng.integers(0, body.size - l))
        p = body[i: i + l].tobytes()
        if rng.random() < 0.2:  # a near miss
            p = p[:-1] + b'\x7f'
        pats.append(p)
    return pats


@pytest.mark.parametrize('kind', ['ranked', 'ranked6', 'nul'])
@pytest.mark.parametrize('depth,K', [(2, 3), (4, 2)])
def test_aux_kernels_match_plain(cuda, kind, depth, K):
    body = _body(kind, 50_000, 1)
    n = body.size
    N = _pad_len(n + S.PAD_MARGIN)
    pres = np.bincount(body, minlength=256)[:256] > 0
    rank, sigma = S.alphabet_rank(pres)
    bits = S.ranked_bits(sigma)
    base = 1 << bits
    depth = min(depth, S.ranked_limb_bytes(bits))
    text = torch.zeros(N, dtype=torch.uint8, device=cuda)
    text[:n] = torch.from_numpy(body)
    sa = torch.zeros(N, dtype=torch.int32, device=cuda)
    sa[:n] = torch.from_numpy(suffix_array_numpy(body))
    rk = torch.from_numpy(rank).to(cuda)
    before = dict(kernels.LAUNCHES)
    packed = S.ranked_pack(text, n, rk, bits)
    limbs = S.ranked_limb_planes(text, sa, n, rk, depth, bits, K)
    table = S.seed_table(packed, sa, n, base, depth, bits)
    torch.cuda.synchronize()
    for name in ('ranked_pack', 'ranked_limb_planes', 'seed_table'):
        assert kernels.LAUNCHES[name] == before[name] + 1
    ref = S.ranked_pack_plain(text, n, rk, bits)
    assert torch.equal(packed, ref)
    assert torch.equal(limbs, S.ranked_limb_planes_plain(ref, sa, n, depth,
                                                         bits, K))
    assert torch.equal(limbs, S.ranked_limb_planes_text_plain(
        text, sa, n, rk, depth, bits, K))
    assert torch.equal(table, S.seed_table_plain(ref, sa, n, base, depth,
                                                 bits))
    host = S.pad_limbs_host(S.build_ranked_limbs_host(
        body, sa[:n].cpu().numpy(), rank, K, depth, bits), N)
    assert np.array_equal(limbs.cpu().numpy(), host)


#: K1 at both digit widths and K7 at every table combination.
PACK_MODES = [('ranked_pack', 5, 0), ('ranked_pack', 6, 0)] + [
    ('seed_prefix', base, depth) for base, depth in S._TABLE_COMBOS]


@pytest.mark.parametrize('name, a, b', PACK_MODES,
                         ids=lambda m: str(m))
@pytest.mark.parametrize('N', [4096, 4097, 4111, (1 << 20) + 15])
@pytest.mark.parametrize('at', ['0', '1', 'N-D', 'N-1', 'N'])
@pytest.mark.parametrize('offsets', [(0, 0), (1, 0), (0, 1)])
def test_packs_match_plain_at_tile_edges(cuda, name, a, b, N, at, offsets):
    """K1 (``a`` bits) and K7 (base ``a``, depth ``b``) bit for bit against
    their plain versions, one launch each: rows that end in a partial tile
    (the byte loads and scalar stores of a row's last tile), true lengths
    0, 1 and up to the row's end (windows crossing n and N, bytes past n
    that must not count), and a text view one byte into its buffer or an
    out view one int into its own (off the 16-byte alignment: the
    byte-load form)."""
    D = S.ranked_limb_bytes(a) if name == 'ranked_pack' else b
    n = {'0': 0, '1': 1, 'N-D': N - D, 'N-1': N - 1, 'N': N}[at]
    rng = np.random.default_rng(N + n + a + b)
    if name == 'ranked_pack' or a != 258:
        size = 30 if name == 'ranked_pack' and a == 5 else (
            62 if name == 'ranked_pack' else a - 2)
        alphabet = rng.choice(256, size=size, replace=False).astype(np.uint8)
        body = alphabet[rng.integers(0, size, size=N)]
        rank = S.alphabet_rank(np.bincount(alphabet, minlength=256)[:256]
                               > 0)[0]
    else:
        body = rng.integers(0, 256, size=N, dtype=np.uint8)
        rank = S.identity_rank()[0]
    toff, ooff = offsets
    text = torch.zeros(N + toff, dtype=torch.uint8, device=cuda)[toff:]
    text.copy_(torch.from_numpy(body))
    out = torch.full((N + ooff,), -1, dtype=torch.int32, device=cuda)[ooff:]
    rk = torch.from_numpy(rank).to(cuda)
    before = kernels.LAUNCHES[name]
    if name == 'ranked_pack':
        got = S.ranked_pack(text, n, rk, a, out=out)
        want = S.ranked_pack_plain(text, n, rk, a)
    else:
        got = S.seed_prefix(text, n, rk, a, b, out=out)
        want = S.seed_prefix_plain(text, n, rk, a, b)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == before + 1
    assert got.data_ptr() == out.data_ptr()
    assert torch.equal(got, want)


@pytest.mark.parametrize('kind, mode', [
    ('ranked', 'upload'), ('ranked6', 'upload'), ('nul', 'upload'),
    ('raw', 'upload'), ('ranked', 'derive'), ('ranked6', 'derive'),
    ('nul', 'derive'), ('raw', 'derive'),
])
def test_index_and_probe_match_cpu(cuda, kind, mode):
    """A multi-row index built on the card equals the CPU one array for
    array (in derive mode: the SA built by B1 and B2 over a merged row),
    and the probe kernel equals the plain probe for every (row, pattern),
    lower bounds included."""
    bodies = [_body(kind, m, s) for s, m in enumerate((30_000, 777, 52_000))]
    chunks = [Chunk(data=b, suffix_array=suffix_array_numpy(b))
              for b in bodies]
    gpu = DeviceIndex(chunks, device=cuda, mode=mode)
    cpu = DeviceIndex(chunks, device='cpu', mode=mode)
    torch.cuda.synchronize()
    assert gpu.merged == (mode == 'derive') and gpu.groups == cpu.groups
    for name in ('text', 'lengths', 'sa', 'tables', 'limbs', 'rank',
                 'present'):
        assert torch.equal(getattr(gpu, name).cpu(), getattr(cpu, name)), name
    if mode == 'derive':
        n = gpu.row_data[0].size
        assert np.array_equal(gpu.sa[0, :n].cpu().numpy(),
                              suffix_array_numpy(gpu.row_data[0]))
    packed, lengths = S.pack_patterns(_patterns(bodies, 2))
    before = kernels.LAUNCHES['probe_phased']
    lo_g, cnt_g = gpu.probe(packed, lengths)
    assert kernels.LAUNCHES['probe_phased'] == before + 1
    lo_c, cnt_c = cpu.probe(packed, lengths)
    np.testing.assert_array_equal(cnt_g, cnt_c)
    np.testing.assert_array_equal(lo_g, lo_c)
    assert (cnt_g > 0).sum() > 100


def test_reader_on_card_matches_cpu_reader(cuda, tmp_path, monkeypatch):
    rng = np.random.default_rng(7)
    words = [bytes(rng.integers(97, 123, size=int(l), dtype=np.uint8))
             for l in rng.integers(3, 10, size=300)]
    lines = [b' '.join(words[i] for i in rng.integers(0, 300, size=6))
             for _ in range(8000)]
    path = str(tmp_path / 'x.idx')
    with pss.Writer(path, max_chunk_len=32 << 10) as w:
        for ln in lines:
            w.add_entry(ln.decode())
    pats = [ln[2:2 + int(k)].decode()
            for ln, k in zip(lines[::40], rng.integers(2, 30, size=200))]
    pats += ['', '\n', 'zzqqzzqq', lines[5].decode() + '\n' + lines[6][:3].decode()]
    gpu = pss.Reader(path)
    assert gpu.wait_device_ready(timeout=300)
    assert gpu._index.mode == 'derive' and gpu._index.merged
    cpu = pss.Reader(path, device='cpu')
    want = collections.Counter(cpu.search_multiple(pats))
    # Under the routing rule, then on the device route forced (the host
    # estimate infinite, no readback cap), which gathers on the card.
    assert collections.Counter(gpu.search_multiple(pats)) == want
    with monkeypatch.context() as m:
        m.setattr(pss.api, 'HOST_PROBE_UNIT_S', float('inf'))
        m.setattr(pss.api.Reader, '_READBACK_CAP', 1 << 62)
        before = kernels.LAUNCHES['gather_hits_flat']
        assert collections.Counter(gpu.search_multiple(pats)) == want
        assert kernels.LAUNCHES['gather_hits_flat'] > before
    up = pss.Reader(path, index_mode='upload')
    assert up.wait_device_ready(timeout=300) and up._index.mode == 'upload'
    assert collections.Counter(up.search_multiple(pats)) == \
        collections.Counter(cpu.search_multiple(pats))


@pytest.mark.parametrize('n', [1, (1 << 20) + 7, 1 << 24])
def test_radix_sort_matches_stable_torch_sort(cuda, n):
    g = torch.Generator(device='cpu').manual_seed(n)
    hi = torch.randint(0, 97, (n,), generator=g, dtype=torch.int64)
    lo = torch.randint(0, 5, (n,), generator=g, dtype=torch.int64)
    keys = ((hi << 50) | lo).to(cuda)  # many duplicates, 57 key bits
    vals = torch.arange(n, dtype=torch.int32, device=cuda)
    ref_k, order = torch.sort(keys, stable=True)
    before = kernels.LAUNCHES['radix_sort_pairs']
    ks, vs = SA.radix_sort_pairs(keys.clone(), vals.clone(), 57)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES['radix_sort_pairs'] == before + 1
    assert torch.equal(ks, ref_k)
    assert torch.equal(vs, order.to(torch.int32))


def _sort_keys(n, key_bits, kind, device):
    """int64 keys below 2^key_bits: random, all equal, sorted or
    reversed."""
    g = torch.Generator(device='cpu').manual_seed(n + key_bits)
    if kind == 'equal':
        return torch.full((n,), (1 << key_bits) - 3, dtype=torch.int64,
                          device=device)
    keys = torch.randint(0, 1 << key_bits, (n,), generator=g,
                         dtype=torch.int64).to(device)
    if kind == 'sorted':
        keys = torch.sort(keys).values
    elif kind == 'reversed':
        keys = torch.sort(keys, descending=True).values
    return keys


SORT_TILE = 4096  # pairs a block of the one-sweep sort takes


SORT_CASES = [(n, bits, 'random') for bits in (25, 30, 55, 60, 62)
              for n in (0, 1, SORT_TILE - 1, SORT_TILE, SORT_TILE + 1,
                        (1 << 24) + 5)]
SORT_CASES += [(n, 60, kind) for kind in ('equal', 'sorted', 'reversed')
               for n in (SORT_TILE + 1, (1 << 24) + 5)]


@pytest.mark.parametrize('n, key_bits, kind', SORT_CASES)
def test_onesweep_sort_matches_stable_torch_sort(cuda, n, key_bits, kind):
    """The one-sweep radix sort, bit for bit with stable torch.sort, at
    every pass count the builds use, around one tile and past 2^24, and on
    all-equal (one digit a pass), sorted and reversed keys."""
    keys = _sort_keys(n, key_bits, kind, cuda)
    vals = torch.arange(n, dtype=torch.int32, device=cuda)
    ref_k, order = torch.sort(keys, stable=True)
    ks, vs = SA.radix_sort_pairs(keys.clone(), vals.clone(), key_bits)
    torch.cuda.synchronize()
    assert torch.equal(ks, ref_k)
    assert torch.equal(vs, order.to(torch.int32))


def test_onesweep_sorts_on_two_threads(cuda):
    """Two sorts at once on two threads, each on its own stream: the tile
    counters and status words live in each call's scratch."""
    import threading

    n = (1 << 22) + 17
    inputs = [_sort_keys(n, bits, 'random', cuda) for bits in (55, 30)]
    refs = [torch.sort(k, stable=True) for k in inputs]
    torch.cuda.synchronize()
    out = [None, None]

    def run(i):
        stream = torch.cuda.Stream()
        with torch.cuda.stream(stream):
            for _ in range(4):
                ks, vs = SA.radix_sort_pairs(
                    inputs[i].clone(),
                    torch.arange(n, dtype=torch.int32, device=cuda),
                    (55, 30)[i])
            stream.synchronize()
        out[i] = (ks, vs)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    for (ks, vs), (rk, order) in zip(out, refs):
        assert torch.equal(ks, rk)
        assert torch.equal(vs, order.to(torch.int32))


@pytest.mark.parametrize('n', [1, 2049, (1 << 22) + 5])
def test_scans_match_cumsum_and_cummax(cuda, n):
    """The exclusive sum scan against ``torch.cumsum``, and the giant
    relabel's two max scans against its plain version's ``torch.cummax``
    on a list of n pairs."""
    g = torch.Generator(device='cpu').manual_seed(n)
    x = torch.randint(-50, 1000, (n,), generator=g,
                      dtype=torch.int32).to(cuda)
    ex = SA.scan_exclusive_sum(x)
    assert ex.shape == (n + 1,) and int(ex[0]) == 0
    assert torch.equal(ex[1:], torch.cumsum(x, 0).to(torch.int32))
    keys = torch.from_numpy(_relabel_list(n, 3, n)).to(cuda)
    assert torch.equal(SA.giant_relabel(keys, 0, None, None, 31, -1, -1),
                       SA.giant_relabel_plain(keys, 0, None, None, 31, -1,
                                              -1))


def _word_row(size, seed, device):
    rng = np.random.default_rng(seed)
    vocab = [bytes(rng.integers(97, 123, size=int(l), dtype=np.uint8))
             for l in rng.integers(2, 7, size=300)]
    data = np.frombuffer(b' '.join(vocab[i] for i in rng.integers(
        0, 300, size=size // 4))[:size], dtype=np.uint8)
    n = data.size
    N = _pad_len(n + S.PAD_MARGIN)
    pres = np.bincount(data, minlength=256)[:256] > 0
    rank, sigma = S.alphabet_rank(pres)
    text = torch.zeros(N, dtype=torch.uint8, device=device)
    text[:n] = torch.from_numpy(data.copy())
    return data, text, n, torch.from_numpy(rank).to(device), \
        S.ranked_bits(sigma)


@pytest.mark.parametrize('size', [50_000, 3_000_000])
def test_sa_kernels_match_plain(cuda, size):
    data, text, n, rank, bits = _word_row(size, size, cuda)
    before = dict(kernels.LAUNCHES)
    init = SA.sa_init_ranked(text, n, rank, bits)
    plain = SA.sa_init_ranked_plain(text, n, rank, bits)
    for a, b in zip(init, plain):
        assert torch.equal(a, b)
    k = 2 * (30 // bits)
    state = [t.clone() for t in init]
    m = SA.sa_refine_round(*state, k)
    pm = SA.sa_refine_round_plain(*plain, k)
    assert m == pm > 0
    for a, b in zip(state, plain):
        assert torch.equal(a, b)
    sa, ties, _ = SA.derive_sa(text, n, rank, bits)
    psa, pties, _ = SA.derive_sa_plain(text, n, rank, bits)
    torch.cuda.synchronize()
    assert ties == pties and ties[0] == m
    assert torch.equal(sa, psa)
    assert np.array_equal(sa[:n].cpu().numpy(), suffix_array_native(data))
    for name in ('sa_init_ranked', 'sa_tie_scan', 'sa_refine_round',
                 'sa_roll_front'):
        assert kernels.LAUNCHES[name] > before[name], name


def test_gather_hits_flat_matches_plain(cuda):
    rng = np.random.default_rng(9)
    N = 1 << 20
    sa_row = torch.from_numpy(rng.permutation(N).astype(np.int32)).to(cuda)
    B = 5000
    lower = rng.integers(0, N - 5000, size=B).astype(np.int32)
    count = rng.integers(0, 5000, size=B).astype(np.int32)
    count[::4] = 0
    lo = torch.from_numpy(lower).to(cuda)
    cnt = torch.from_numpy(count).to(cuda)
    before = kernels.LAUNCHES['gather_hits_flat']
    pos, qid = S.gather_hits_flat(sa_row, lo, cnt)
    ppos, pqid = S.gather_hits_flat_plain(sa_row, lo, cnt)
    assert kernels.LAUNCHES['gather_hits_flat'] == before + 1
    assert pos.shape == (int(count.sum()),)
    assert torch.equal(pos, ppos) and torch.equal(qid, pqid)
    empty = torch.zeros(0, dtype=torch.int32, device=cuda)
    assert S.gather_hits_flat(sa_row, empty, empty)[0].shape == (0,)


@pytest.mark.parametrize('big', [1 << 16, (1 << 24) + 3])
def test_gather_hits_flat_skewed_batch(cuda, big):
    """B8 parallel over output slots: one query holding most of the hits
    beside 10,000 small ones and runs of zero counts, the total crossing
    many output tiles."""
    sa_row, lower, count = sort_bench.skewed_batch(big, 1 << 25, big, 777)
    sa_row, lo, cnt = (torch.from_numpy(a).to(cuda)
                       for a in (sa_row, lower, count))
    before = kernels.LAUNCHES['gather_hits_flat']
    pos, qid = S.gather_hits_flat(sa_row, lo, cnt)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES['gather_hits_flat'] == before + 1
    ppos, pqid = S.gather_hits_flat_plain(sa_row, lo, cnt)
    assert pos.shape == (int(count.astype(np.int64).sum()),)
    assert torch.equal(pos, ppos) and torch.equal(qid, pqid)


def _raw_row(size, seed, device):
    """A raw-kind row: printable words (bytes 33-126) for the word text,
    every byte but NUL for the rest."""
    rng = np.random.default_rng(seed)
    if size >= 1 << 24:
        vocab = [bytes(rng.integers(33, 127, size=int(l), dtype=np.uint8))
                 for l in rng.integers(3, 12, size=3000)]
        data = np.frombuffer(b' '.join(vocab[i] for i in rng.integers(
            0, 3000, size=size // 6))[:size], dtype=np.uint8).copy()
    else:
        data = rng.integers(1, 256, size=size, dtype=np.uint8)
    n = data.size
    N = _pad_len(n + S.PAD_MARGIN)
    text = torch.zeros(N, dtype=torch.uint8, device=device)
    text[:n] = torch.from_numpy(data)
    return data, text, n


@pytest.mark.parametrize('size', [1, (1 << 20) + 7, 1 << 24])
def test_raw_kernels_match_plain(cuda, size):
    """B1b, one B2 round from k = 6, the raw derive_sa, K5, K6 and K7 with
    K3 (the row's own alphabet and the identity rank at base 258), each
    bit for bit against its plain version."""
    data, text, n = _raw_row(size, size, cuda)
    before = dict(kernels.LAUNCHES)
    init = SA.sa_init_bytes(text, n)
    plain = SA.sa_init_bytes_plain(text, n)
    for a, b in zip(init, plain):
        assert torch.equal(a, b)
    state = [t.clone() for t in init]
    m = SA.sa_refine_round(*state, 6)
    pm = SA.sa_refine_round_plain(*plain, 6)
    assert m == pm
    for a, b in zip(state, plain):
        assert torch.equal(a, b)
    sa, ties, _ = SA.derive_sa(text, n)
    psa, pties, _ = SA.derive_sa_plain(text, n)
    torch.cuda.synchronize()
    assert ties == pties and torch.equal(sa, psa)
    assert np.array_equal(sa[:n].cpu().numpy(), suffix_array_native(data))
    if size >= 1 << 24:
        assert len(ties) >= 2 and ties[0] == m > 0

    packed = S.raw_pack(text, n)
    assert torch.equal(packed, S.raw_pack_plain(text, n))
    limbs = S.raw_limb_planes(text, sa, n, 3, 3)
    assert torch.equal(limbs, S.raw_limb_planes_plain(packed, sa, n, 3, 3))
    assert torch.equal(limbs, S.raw_limb_planes_text_plain(text, sa, n, 3,
                                                           3))
    host = S.pad_limbs_host(S.build_raw_limbs_host(
        data, sa[:n].cpu().numpy(), 3, 3), text.shape[0])
    assert np.array_equal(limbs.cpu().numpy(), host)
    pres = np.bincount(data, minlength=256)[:256] > 0
    rank, sigma = S.alphabet_rank(pres)
    base, depth = S.pick_table_params(sigma, n)
    ident, _ = S.identity_rank()
    for rk, b, d in ((rank, base, depth), (ident, 258, 3)):
        rk = torch.from_numpy(rk).to(cuda)
        pv = S.seed_prefix(text, n, rk, b, d)
        assert torch.equal(pv, S.seed_prefix_plain(text, n, rk, b, d))
        table = S.seed_table_from_prefix(pv, sa, n, b, d)
        assert torch.equal(table, S.seed_table_from_prefix_plain(pv, sa, n,
                                                                 b, d))
    assert np.array_equal(table.cpu().numpy(), S.build_seed_table_host(
        data, sa[:n].cpu().numpy(), ident, 258, 3))
    torch.cuda.synchronize()
    for name in ('sa_init_bytes', 'sa_tie_scan', 'raw_pack',
                 'raw_limb_planes', 'seed_prefix', 'seed_table'):
        assert kernels.LAUNCHES[name] > before[name], name


#: A raw row length that is a multiple of neither 16 (a thread's tile)
#: nor 512 (a warp's staged stores), and true lengths at its end.
K5_N = 100_003
K5_NS = (0, K5_N - 3, K5_N - 2, K5_N - 1, K5_N)


@pytest.mark.parametrize('offset', [0, 1])
@pytest.mark.parametrize('n', K5_NS)
def test_raw_pack_matches_plain_at_row_edges(cuda, n, offset):
    """K5 on K1's tile template against ``raw_pack_plain`` at true lengths
    up to the row's end, on an aligned row and output (the 16-byte form)
    and on views one element off the alignment (the byte-load form); bytes
    past n must not count."""
    body = _body('raw', K5_N, 11)
    buf = torch.full((K5_N + 1,), 0x7e, dtype=torch.uint8, device=cuda)
    text = buf[offset: offset + K5_N]
    text[:n] = torch.from_numpy(body[:n]).to(cuda)
    out = torch.empty(K5_N + 1, dtype=torch.int32,
                      device=cuda)[offset: offset + K5_N]
    before = kernels.LAUNCHES['raw_pack']
    packed = S.raw_pack(text, n, out=out)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES['raw_pack'] == before + 1
    assert torch.equal(packed, S.raw_pack_plain(text, n))
    assert (packed[n:] == torch.iinfo(torch.int32).min).all()


def _digit_body(size: int, seed: int) -> np.ndarray:
    """UTF-16LE text of printable words: every second byte is NUL, so the
    alphabet is wide and holds NUL, the digit kind."""
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(33, 127, size=int(l), dtype=np.uint8))
             for l in rng.integers(2, 8, size=400)]
    text = b' '.join(words[i] for i in rng.integers(0, 400,
                                                      size=size // 8 + 1))
    body = np.frombuffer(text.decode().encode('utf-16-le')[:size],
                         dtype=np.uint8).copy()
    body[::97] = 0x0A
    body[-1] = 0x0A
    return body


@pytest.mark.parametrize('size', [1, 70_000, 3_000_000])
@pytest.mark.parametrize('depth', [2, 3])
def test_digit_aux_kernels_match_plain(cuda, size, depth):
    """B12d: the bucket table (K7 at base 258, K3) and the limb planes (the
    limb-plane kernel on the text at offset 2, stride 3, no K7), bit for
    bit against their plain versions and the host builders."""
    data = _digit_body(size, size)
    n = data.size
    N = _pad_len(n + S.PAD_MARGIN)
    text = torch.zeros(N, dtype=torch.uint8, device=cuda)
    text[:n] = torch.from_numpy(data)
    sa = SA.derive_sa(text, n)[0]
    before = dict(kernels.LAUNCHES)
    scratch = torch.empty(N, dtype=torch.int32, device=cuda)
    table = S.digit_bucket_table(text, sa, n, depth, scratch=scratch)
    limbs = S.digit_limb_planes(text, sa, n, 5)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES['seed_prefix'] == before['seed_prefix'] + 1
    assert kernels.LAUNCHES['seed_table'] == before['seed_table'] + 1
    assert kernels.LAUNCHES['digit_limb_planes'] == \
        before['digit_limb_planes'] + 1
    assert torch.equal(table, S.digit_bucket_table_plain(text, sa, n, depth))
    assert torch.equal(limbs, S.digit_limb_planes_plain(text, sa, n, 5))
    # The JAX program's route: K7's depth-3 values gathered at offset 2,
    # stride 3, on a row padded past n.
    pv = S.seed_prefix(text, n, torch.from_numpy(S.identity_rank()[0]).to(
        cuda), 258, 3)
    assert torch.equal(limbs, S._limb_planes_plain(pv, sa, n, 2, 3, 5))
    sa_h = sa[:n].cpu().numpy()
    assert np.array_equal(table.cpu().numpy(),
                          S.build_bucket_table_host(data, sa_h, depth))
    assert np.array_equal(limbs.cpu().numpy(), S.pad_limbs_host(
        S.build_limbs_host(data, sa_h, 5), N))


def _limb_row(kind, N, n, seed, dev, text_off=0, sa_off=0):
    """A text row of N bytes (random bytes of the kind's alphabet below n,
    other bytes past it, which must not count) and an SA row: a
    permutation of [0, n) with the row's last suffixes n - 1, n - 2, n - 3
    in its first slots, then the pads N - 1, ..., n; each as a view
    ``text_off`` or ``sa_off`` elements into its buffer (misaligned for the
    kernel's 16-byte loads and stores when not 0)."""
    rng = np.random.default_rng(seed)
    lo, hi = {'ranked': (97, 123), 'ranked6': (50, 108), 'raw': (33, 127),
              'digit': (0, 256)}[kind]
    body = rng.integers(lo, hi, size=N, dtype=np.uint8)
    body[n:] = 0x7f
    sa = np.empty(N, dtype=np.int32)
    sa[:n] = rng.permutation(n)
    if n >= 3:
        sa[:3] = [n - 1, n - 2, n - 3]
    sa[n:] = np.arange(N - 1, n - 1, -1)
    tbuf = torch.zeros(N + text_off, dtype=torch.uint8, device=dev)
    sbuf = torch.zeros(N + sa_off, dtype=torch.int32, device=dev)
    text, sa_t = tbuf[text_off:], sbuf[sa_off:]
    text.copy_(torch.from_numpy(body))
    sa_t.copy_(torch.from_numpy(sa))
    return body, text, sa_t


def _limb_planes_both(kind, text, sa, n, depth, K, body, spec=True):
    """(kernel planes, their plain version) of one kind; the ranked and raw
    plain versions on the pack are the text twins' specification, so with
    ``spec`` the twin is held against them too."""
    N = text.shape[0]
    if kind.startswith('ranked'):
        pres = np.bincount(body[:n], minlength=256)[:256] > 0
        rank, sigma = S.alphabet_rank(pres)
        bits = S.ranked_bits(max(sigma, 2))
        rk = torch.from_numpy(rank).to(text.device)
        depth = min(depth, S.ranked_limb_bytes(bits))
        got = S.ranked_limb_planes(text, sa, n, rk, depth, bits, K)
        want = S.ranked_limb_planes_text_plain(text, sa, n, rk, depth, bits,
                                               K)
        if spec:
            assert torch.equal(want, S.ranked_limb_planes_plain(
                S.ranked_pack_plain(text, n, rk, bits), sa, n, depth, bits,
                K))
    elif kind == 'raw':
        got = S.raw_limb_planes(text, sa, n, depth, K)
        want = S.raw_limb_planes_text_plain(text, sa, n, depth, K)
        if spec:
            assert torch.equal(want, S.raw_limb_planes_plain(
                S.raw_pack_plain(text, n), sa, n, depth, K))
    else:
        got = S.digit_limb_planes(text, sa, n, K)
        want = S.digit_limb_planes_plain(text, sa, n, K)
    assert got.shape == (K * N,)
    return got, want


@pytest.mark.parametrize('kind, depth, K', [
    ('ranked', 2, 3), ('ranked6', 3, 2), ('raw', 3, 3), ('raw', 2, 1),
    ('digit', 0, 5), ('digit', 0, 2)])
@pytest.mark.parametrize('N', [70_000, 70_001, 4_099])
@pytest.mark.parametrize('at', ['N', 'N-1', 'N-PAD', 'one'])
@pytest.mark.parametrize('offsets', [(0, 0), (1, 0), (5, 1)])
def test_limb_planes_match_plain_at_row_edges(cuda, kind, depth, K, N, at,
                                              offsets):
    """K2, K6 and B12d's limb planes bit for bit against their plain
    versions at true lengths up to the row's end (n = N and N - 1, where
    a ranked or raw plane past N - 1 takes the pack's value at N - 1),
    with windows crossing n, row lengths that are not multiples of 16, and
    text and SA views off the 16-byte alignment (the byte-load and scalar
    paths)."""
    n = {'N': N, 'N-1': N - 1, 'N-PAD': N - S.PAD_MARGIN, 'one': 1}[at]
    body, text, sa = _limb_row(kind, N, n, N + n, cuda, *offsets)
    kname = {'ranked': 'ranked_limb_planes', 'ranked6': 'ranked_limb_planes',
             'raw': 'raw_limb_planes', 'digit': 'digit_limb_planes'}[kind]
    before = kernels.LAUNCHES[kname]
    got, want = _limb_planes_both(kind, text, sa, n, depth, K, body)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[kname] == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize('kind, K', [('ranked', 3), ('raw', 3),
                                     ('digit', 5)])
def test_limb_planes_past_2_31_plane_offsets(cuda, kind, K):
    """The limb planes of a row whose K * N plane offsets pass 2^31 (so
    the last plane's offsets need 64 bits), against their plain versions;
    a random SA row (the kernels take any int32 values) keeps the set-up
    short.  Skips where the card lacks the memory (the plain version holds
    about 30 bytes a slot beside the planes)."""
    N = ((1 << 31) // K + (1 << 22)) // 16 * 16
    n = N - 7
    need = N * (5 + 8 * K + 32) + (4 << 30)
    if torch.cuda.mem_get_info()[0] < need:
        pytest.skip(f'needs {need / 2**30:.0f} GiB of free device memory')
    g = torch.Generator(device=cuda)
    g.manual_seed(K)
    lo, hi = {'ranked': (97, 123), 'raw': (33, 127), 'digit': (0, 256)}[kind]
    text = torch.randint(lo, hi, (N,), generator=g, device=cuda,
                         dtype=torch.uint8)
    sa = torch.randint(0, n, (N,), generator=g, device=cuda,
                       dtype=torch.int32)
    sa[:3] = torch.tensor([n - 1, n - 2, n - 3], dtype=torch.int32)
    body = text[: 1 << 20].cpu().numpy()  # the alphabet
    got, want = _limb_planes_both(kind, text, sa, n, 3, K, body, spec=False)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    del got, want
    torch.cuda.empty_cache()


@pytest.mark.parametrize('mode, deep_min', [('upload', None),
                                            ('derive', None),
                                            ('derive', 1 << 16)])
def test_digit_index_and_probe_match_cpu(cuda, monkeypatch, mode, deep_min):
    """A digit-kind index built on the card equals the CPU one array for
    array, and B11 equals its plain version for every (row, pattern),
    lower bounds included, at both bucket depths."""
    if deep_min is not None:
        monkeypatch.setattr(DeviceIndex, 'DEEP_TABLE_MIN_CHUNK', deep_min)
    bodies = [_digit_body(m, s) for s, m in enumerate((60_000, 777,
                                                        90_000))]
    bodies[1][:256] = np.arange(256, dtype=np.uint8)
    chunks = [Chunk(data=b, suffix_array=suffix_array_numpy(b))
              for b in bodies]
    k7 = kernels.LAUNCHES['seed_prefix']
    gpu = DeviceIndex(chunks, device=cuda, mode=mode)
    cpu = DeviceIndex(chunks, device='cpu', mode=mode)
    torch.cuda.synchronize()
    assert gpu.kind == 'digit' and gpu._depth == (3 if deep_min else 2)
    # K7 once a row, for the table: the limbs gather the text.
    assert kernels.LAUNCHES['seed_prefix'] - k7 == gpu.num_chunks
    for name in ('text', 'lengths', 'sa', 'tables', 'limbs', 'rank',
                 'present'):
        assert torch.equal(getattr(gpu, name).cpu(), getattr(cpu, name)), name
    pats = _patterns(bodies, 4)
    pats += [bodies[0][i: i + l].tobytes() for i, l in
             ((10, 16), (20, 17), (30, 18), (40, 19), (50, 200))]
    packed, lengths = S.pack_patterns(pats)
    before = kernels.LAUNCHES['probe_limbs']
    lo_g, cnt_g = gpu.probe(packed, lengths)
    assert kernels.LAUNCHES['probe_limbs'] == before + 1
    lo_c, cnt_c = cpu.probe(packed, lengths)
    np.testing.assert_array_equal(cnt_g, cnt_c)
    np.testing.assert_array_equal(lo_g, lo_c)
    assert (cnt_g > 0).sum() > 100


@pytest.mark.parametrize('kind,n,N', [
    ('words', 70_000, 1 << 17), ('words', 70_000, 1 << 18),
    ('words', (1 << 20) - 9, 1 << 20), ('words', (1 << 20) + 5, 1 << 21),
    ('repeat', 3000, 4096), ('digit', 200_000, 1 << 19),
    ('one', 1, 8), ('empty', 0, 64)])
def test_full_rounds_match_plain(cuda, kind, n, N):
    """B9's init and every round of its loop on the card against the plain
    versions (sa, dense ranks and both counts), each round both as the
    segmented refine and as the full sort, n = N - 9 up to n about N / 2;
    one sa_full_round launch a round; the loop's result with its
    closed-form pads equal to the plain loop's and native SA-IS."""
    if kind == 'words':
        data = np.frombuffer(b' '.join(
            b'%x' % w for w in np.random.default_rng(n).integers(
                0, 3000, size=n))[:n], np.uint8).copy()
    elif kind == 'digit':
        data = _digit_body(n, 5)
    else:
        data = np.full(n, ord('a'), np.uint8)
    text = torch.zeros(N, dtype=torch.uint8, device=cuda)
    text[:n] = torch.from_numpy(data)
    init = SA._full_init_bytes(text, n)
    pinit = SA._full_init_bytes_plain(text.cpu(), n)
    assert init[2:] == pinit[2:]
    assert all(torch.equal(a.cpu(), b) for a, b in zip(init[:2], pinit[:2]))
    sa, rank, _, real = init
    psa, prank = (t.clone() for t in pinit[:2])
    W, k, rounds = SA._key_width(N), 6, 0
    before = kernels.LAUNCHES['sa_full_round']
    while k < N and real < n:
        want = SA._full_key_round_plain(psa, prank, k, W, n)
        for count in (None, 0):  # the segmented refine, then the full sort
            state = [sa.clone(), rank.clone()]
            counts = SA._full_round(*state, k, W, n, count)
            assert counts == want, (k, count)
            assert torch.equal(state[0].cpu(), psa)
            assert torch.equal(state[1].cpu(), prank)
        sa, rank = state
        real, k, rounds = want[1], 2 * k, rounds + 1
    torch.cuda.synchronize()
    assert kernels.LAUNCHES['sa_full_round'] - before == 2 * rounds
    before = kernels.LAUNCHES['sa_full_round']
    full = SA.sa_full_doubling(text, n)
    assert kernels.LAUNCHES['sa_full_round'] - before == rounds
    assert torch.equal(full.cpu(), SA.sa_full_doubling_plain(text.cpu(), n))
    assert torch.equal(full[:N - n].cpu(),
                       torch.arange(N - 1, n - 1, -1, dtype=torch.int32))
    if n:
        assert np.array_equal(full[N - n:].cpu().numpy(),
                              suffix_array_native(data))
    vals = data.astype(np.int32)
    ranks = torch.zeros(N, dtype=torch.int32, device=cuda)
    ranks[:n] = torch.from_numpy(vals + 1)
    iinit = SA.sa_full_init_int(ranks, n)
    piinit = SA.sa_full_init_int_plain(ranks.cpu(), n)
    assert iinit[2:] == piinit[2:]
    assert all(torch.equal(a.cpu(), b) for a, b in zip(iinit[:2], piinit[:2]))
    assert torch.equal(SA.sa_full_doubling_int(ranks, n).cpu(),
                       SA.sa_full_doubling_int_plain(ranks.cpu(), n))


def _seed_rows():
    """(name, sorted keys [n], shift, size): the K3 rows the derive path
    never makes but must survive."""
    rng = np.random.default_rng(4)
    n = 300_000
    yield 'uniform', np.sort(rng.integers(0, 1 << 15, n)), 0, (1 << 15) + 1
    skew = np.sort(np.where(rng.random(n) < 0.97, 777,
                            rng.integers(0, 1 << 15, n)))
    yield 'one bucket', skew, 0, (1 << 15) + 1
    yield 'sparse', np.sort(rng.choice([5, 40_000, 900_000], n)), 0, 1 << 20
    yield 'shifted', np.sort(rng.integers(-(1 << 22), 1 << 22, n)), 9, \
        (1 << 21) + 1
    yield 'longer than n', np.sort(rng.integers(0, 1 << 22, 500)), 2, \
        (1 << 20) + 1
    yield 'n = 1', np.array([3]), 0, 4097
    yield 'n = 0', np.zeros(0, np.int64), 0, 4097


@pytest.mark.parametrize('row', list(range(7)))
def test_seed_table_matches_plain_on_skewed_rows(cuda, row):
    """K3 against its plain version on rows the main path does not make:
    one bucket holding 97% of the row, long runs of empty entries, a table
    longer than n, n = 0 and 1, shift 0 and above, negative keys."""
    name, keys, shift, size = list(_seed_rows())[row]
    n = keys.size
    N = n + 37
    rng = np.random.default_rng(row)
    sa = rng.permutation(N).astype(np.int32)
    packed = np.full(N, -(1 << 31), np.int64)
    packed[sa[:n]] = keys << shift
    packed = torch.from_numpy(packed.astype(np.int32)).to(cuda)
    sa = torch.from_numpy(sa).to(cuda)
    before = kernels.LAUNCHES['seed_table']
    got = S._table(packed, sa, n, size, shift, None)
    assert kernels.LAUNCHES['seed_table'] == before + 1
    want = S._table_plain(packed.cpu(), sa.cpu(), n, size, shift)
    assert torch.equal(got.cpu(), want), name


@pytest.mark.parametrize('size', [1, 70_000, (1 << 22) + 3])
def test_full_doubling_matches_plain(cuda, size):
    """B9's byte form (init, every round, the finished SA with its pad
    slots) and integer form against their plain versions and native
    SA-IS."""
    data = _digit_body(size, 3) if size > 1 else np.array([7], np.uint8)
    n = data.size
    N = _pad_len(n + 6)
    text = torch.zeros(N, dtype=torch.uint8, device=cuda)
    text[:n] = torch.from_numpy(data)
    before = dict(kernels.LAUNCHES)
    init = SA.sa_full_init_bytes(text, n)
    pinit = SA.sa_full_init_bytes_plain(text, n)
    assert init[2] == pinit[2]
    assert all(torch.equal(a, b) for a, b in zip(init[:2], pinit[:2]))
    sa = SA.sa_full_doubling(text, n)
    assert torch.equal(sa, SA.sa_full_doubling_plain(text, n))
    assert np.array_equal(sa[N - n:].cpu().numpy(), suffix_array_native(data))
    assert np.array_equal(SA.suffix_array_torch(data, algorithm='full'),
                          SA.suffix_array_torch(data))
    vals = np.random.default_rng(size).integers(0, 1 << 20, size=n,
                                                dtype=np.int32)
    vals[::5] = vals[0]
    ranks = torch.zeros(_pad_len(n), dtype=torch.int32, device=cuda)
    ranks[:n] = torch.from_numpy(vals + 1)
    assert torch.equal(SA.sa_full_doubling_int(ranks, n),
                       SA.sa_full_doubling_int_plain(ranks, n))
    assert np.array_equal(SA.suffix_array_int(vals, 1 << 20, 'torch'),
                          SA.suffix_array_int(vals, 1 << 20, 'native'))
    torch.cuda.synchronize()
    for name in ('sa_full_init_bytes', 'sa_full_init_ranks'):
        assert kernels.LAUNCHES[name] > before[name], name
    # One byte is settled by the init: no round runs.
    rounds = kernels.LAUNCHES['sa_full_round'] - before['sa_full_round']
    assert (rounds > 0) == (size > 1)


def test_writer_auto_builds_on_card(cuda, tmp_path):
    """The Writer's default 'auto' builds every chunk of at least 64 KiB on
    the card (one B1b launch each) from its thread pool, and writes the
    bytes of a native build."""
    src = tmp_path / 'corpus.txt'
    src.write_bytes(_digit_body(700_000, 9).tobytes())
    paths = {}
    for backend in ('auto', 'native'):
        paths[backend] = str(tmp_path / f'{backend}.idx')
        before = kernels.LAUNCHES['sa_init_bytes']
        with pss.Writer(paths[backend], max_chunk_len=100 << 10,
                        sa_backend=backend) as w:
            w.add_entries_from_file_lines(str(src))
        launched = kernels.LAUNCHES['sa_init_bytes'] - before
        sizes = [c.data.size for c in
                 read_container(paths[backend]).chunks]
        big = sum(s >= SA.DEVICE_MIN_N for s in sizes)
        assert big >= 4
        assert launched == (big if backend == 'auto' else 0)
    with open(paths['auto'], 'rb') as f, open(paths['native'], 'rb') as g:
        assert f.read() == g.read()


def _probe_rows(bodies, device, N=None, off=0):
    """(text, n, sa) of ``bodies`` as [C, N] rows (N by default the
    padding of the longest, so rows off the 16-byte alignment where N is
    no multiple of 16), the text a view ``off`` bytes into its buffer; SA
    by native SA-IS, 0 past n."""
    N = N or _pad_len(max(b.size for b in bodies) + S.PAD_MARGIN)
    C = len(bodies)
    buf = torch.zeros(C * N + off, dtype=torch.uint8, device=device)
    text = buf[off:].view(C, N)
    sa = torch.zeros((C, N), dtype=torch.int32, device=device)
    for i, b in enumerate(bodies):
        text[i, : b.size] = torch.from_numpy(b)
        if b.size:
            sa[i, : b.size] = torch.from_numpy(suffix_array_native(b))
    n = torch.tensor([b.size for b in bodies], dtype=torch.int32,
                     device=device)
    return text, n, sa


def _slices(bodies, lengths, per, seed, misses=True):
    """``per`` slices of each length from each body, each beside a near
    miss (its last byte flipped)."""
    rng = np.random.default_rng(seed)
    pats = []
    for l in lengths:
        for b in bodies:
            if b.size < l:
                continue
            for o in rng.integers(0, b.size - l + 1, size=per):
                p = b[o: o + l].tobytes()
                pats.append(p)
                if misses:
                    pats.append(p[:-1] + bytes([p[-1] ^ 1]))
    return pats


def _row_end_patterns(bodies, lengths):
    """Each body's last bytes, and the same with a byte after them: the
    suffixes that end at n must rank below every byte, 0x00 included."""
    pats = []
    for b in bodies:
        for l in lengths:
            if 0 < l <= b.size:
                tail = b[b.size - l:].tobytes()
                pats += [tail, tail + b'\x00', tail + b'\x01', tail + b'\xff']
    return pats


def _repeats(size, seed):
    """A random block repeated with a few bytes changed: suffixes that
    share hundreds of bytes."""
    rng = np.random.default_rng(seed)
    block = rng.integers(97, 103, size=997, dtype=np.uint8)
    body = np.tile(block, size // block.size + 1)[:size]
    body[rng.integers(0, size, size=size // 500)] = 0x7a
    return body


#: B15's cases: row sizes, and the edges of the wide compare.
PROBE_BYTES_CASES = [1, 70_000, 3_000_000, 'lengths', 'long_matches',
                     'row_ends', 'offset_rows', 'repeated', 'offsets64']


def _probe_bytes_case(case, device):
    """(text, n, sa, patterns, lengths) of one of ``PROBE_BYTES_CASES``:
    row sizes 1 to 3 M (an empty row among them), pattern lengths around
    16 and 32 and past L, patterns that match 100-300 bytes of many
    suffixes, 0x00 and 0xFF at the row ends, rows off the 16-byte
    alignment in a text view off it, one pattern 512 times, and rows whose
    offsets pass 2^31."""
    if isinstance(case, int):
        bodies = [_body('nul', case, 11), _body('raw', max(case // 3, 1), 12),
                  np.zeros(0, np.uint8)]
        pats = _patterns(bodies[:1], 3) if case > 100 else [b'', b'\n', b'a']
        pats.append(bodies[0].tobytes()[:300] + b'x')  # longer than a row
        text, n, sa = _probe_rows(bodies, device)
    elif case == 'offsets64':
        bodies = [_body('nul', 5_000, 1), _body('raw', 70_001, 2),
                  _body('nul', 4_099, 3)]
        pats = [b''] + _slices(bodies, (1, 7, 16, 17, 33, 200), 3, 4)
        text, n, sa = _probe_rows(bodies, device, N=(1 << 30) + 48)
    else:
        bodies = {
            'lengths': lambda: [_body('nul', 70_000, 5), _body('raw', 9_001, 6)],
            'long_matches': lambda: [_repeats(30_011, 7), _repeats(4_099, 8)],
            'row_ends': lambda: [
                np.append(_body('nul', 4_098, 9), [0xff, 0x00]),
                np.append(_body('raw', 70_000, 10), [0x00, 0xff]),
                np.array([0x00], np.uint8), np.array([0xff], np.uint8),
                np.zeros(0, np.uint8)],
            'offset_rows': lambda: [_body('raw', 4_099, 12),
                                    _body('nul', 20_003, 13)],
            'repeated': lambda: [_body('nul', 50_000, 14)],
        }[case]()
        pats = [b'', b'\x00', b'\xff']
        if case == 'lengths':
            pats += _slices(bodies, (15, 16, 17, 31, 32, 33, 48, 49), 8, 15)
        elif case == 'long_matches':
            pats += _slices(bodies, (100, 150, 299, 300), 8, 16)
        elif case == 'row_ends':
            pats += _row_end_patterns(bodies, (1, 2, 3, 15, 16, 17, 33))
        elif case == 'offset_rows':
            pats += _slices(bodies, (1, 5, 16, 17, 40), 10, 17)
            pats += _row_end_patterns(bodies, (1, 16, 17))
        else:
            pats = [bodies[0][123: 163].tobytes()] * 512
        off = 3 if case == 'offset_rows' else 0
        N = _pad_len(max(b.size for b in bodies) + S.PAD_MARGIN) + 5 * (off > 0)
        text, n, sa = _probe_rows(bodies, device, N=N, off=off)
    packed, lengths = S.pack_patterns(pats)
    if case == 'lengths':  # a length past L compares L bytes
        lengths[::7] = packed.shape[1] + 9
    return (text, n, sa, torch.from_numpy(packed).to(device),
            torch.from_numpy(lengths).to(device))


@pytest.mark.parametrize('case', PROBE_BYTES_CASES)
def test_probe_bytes_matches_plain(cuda, case):
    """B15 over [C, N] rows (an empty one among them) equals its plain
    version for every (row, pattern), lower bounds included, in one launch,
    at the edges of its wide compare (``_probe_bytes_case``); probe_bounds
    is its C = 1 case."""
    if case == 'offsets64' and torch.cuda.mem_get_info()[0] < 20 << 30:
        pytest.skip('needs 20 GiB of free device memory')
    text, n, sa, p, l = _probe_bytes_case(case, cuda)
    before = kernels.LAUNCHES['probe_bytes']
    lo, cnt = S.probe_bytes(text, n, sa, p, l)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES['probe_bytes'] == before + 1
    lo_p, cnt_p = S.probe_bytes_plain(text, n, sa, p, l)
    assert torch.equal(lo, lo_p) and torch.equal(cnt, cnt_p)
    if isinstance(case, int):
        assert int(cnt[0, 0]) == case and int(cnt[2].abs().sum()) == 0
        lo1, cnt1 = S.probe_bounds(text[0], case, sa[0], p, l)
        assert torch.equal(lo1, lo[0]) and torch.equal(cnt1, cnt[0])
    else:
        assert int((cnt > 0).sum()) > 0
    del text, sa
    torch.cuda.empty_cache()


def _nul_runs(size, seed):
    """UTF-16 text with runs of 48 NULs every 64 bytes: NUL-led buckets of
    over a million slots in a 3 MB row."""
    body = _digit_body(size, seed)
    body.reshape(-1, 64)[:, 16:] = 0  # size is a multiple of 64
    return body


#: B11's cases: bucket depth 2 or 3, 1, 2 or 5 limbs, and the edges.
PROBE_LIMBS_CASES = ['depth2', 'depth3', 'k1', 'k2', 'big_bucket',
                     'repeated', 'offsets64']


def _probe_limbs_case(case, device):
    """(text, n, sa, tables, limbs, patterns, lengths, num_limbs) of one of
    ``PROBE_LIMBS_CASES``: UTF-16 rows (with every byte value, 0x00 and
    0xFF at the row ends, an empty row and a one-slot row), patterns
    shorter than the bucket depth, k at 1 and at num_limbs, deep patterns
    of 100-300 bytes past the key cover, a NUL-led bucket of over a million
    slots, one pattern many times, and plane offsets past 2^31."""
    depth, K, N = {'depth2': (2, 5, None), 'depth3': (3, 5, None),
                   'k1': (2, 1, None), 'k2': (3, 2, None),
                   'big_bucket': (2, 5, None), 'repeated': (3, 5, None),
                   'offsets64': (2, 5, (1 << 28) + 16)}[case]
    if case == 'big_bucket':
        bodies = [_nul_runs(3 << 20, 21)]
    else:
        bodies = [_digit_body(60_001, 22), _digit_body(777, 23),
                  np.array([0xff], np.uint8), np.zeros(0, np.uint8)]
        bodies[0][-2:] = [0xff, 0x00]
        bodies[1][:256] = np.arange(256, dtype=np.uint8)
        if case == 'offsets64':
            bodies = bodies[:2]
    text, n, sa = _probe_rows(bodies, device, N=N)
    C, Np = text.shape
    tables = torch.stack([S.digit_bucket_table(text[i], sa[i], int(n[i]),
                                               depth) for i in range(C)])
    limbs = torch.stack([S.digit_limb_planes(text[i], sa[i], int(n[i]), K)
                         for i in range(C)])
    pats = [b'', b'\x00', b'\x00\x00', b'a', b'a\x00', b'\xff', b'\xff\x00',
            b'\x00\xff']
    cover = S.key_cover_bytes(K)
    if case == 'repeated':
        pats = [bodies[0][301: 301 + cover + 40].tobytes()] * 300 + [b'\x00'] * 20
    elif case == 'big_bucket':
        pats += [b'\x00' * l for l in (3, 17, 18, 40, 60)]
        pats += _slices(bodies, (2, 6, 17, 18, 64, 150), 6, 24)
    else:
        pats += _slices(bodies, (1, 2, 3, 5, 6, 8, 15, 16, cover, cover + 1,
                                 31, 32, 33, 100, 300), 4, 25)
        pats += _row_end_patterns(bodies, (1, 2, 3, cover, cover + 2))
    packed, lengths = S.pack_patterns(pats)
    return (text, n, sa, tables, limbs, torch.from_numpy(packed).to(device),
            torch.from_numpy(lengths).to(device), K)


@pytest.mark.parametrize('case', PROBE_LIMBS_CASES)
def test_probe_limbs_matches_plain(cuda, case):
    """B11 equals its plain version for every (row, pattern), lower bounds
    included, in one launch, at the edges of its cooperative search and
    its deep wide compare (``_probe_limbs_case``)."""
    if case == 'offsets64' and torch.cuda.mem_get_info()[0] < 24 << 30:
        pytest.skip('needs 24 GiB of free device memory')
    args = _probe_limbs_case(case, cuda)
    before = kernels.LAUNCHES['probe_limbs']
    lo, cnt = S.probe_limbs(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES['probe_limbs'] == before + 1
    lo_p, cnt_p = S.probe_limbs_plain(*args)
    assert torch.equal(lo, lo_p) and torch.equal(cnt, cnt_p)
    assert int((cnt > 0).sum()) > 0
    if case == 'big_bucket':
        assert int(cnt[0, 1]) > 1 << 20  # b'\x00'
    del args
    torch.cuda.empty_cache()


#: K4's cases: ranked (bits 5 and 6) and raw limbs at 1, 3 and 8 limbs, and
#: the edges of the cooperative search and the deep wide compare.
PROBE_PHASED_CASES = ['ranked_k1', 'ranked_k3', 'ranked_k8', 'ranked6_k3',
                      'raw_k1', 'raw_k3', 'raw_k8', 'raw_depth3',
                      'long_matches', 'long_matches_raw', 'offset_rows',
                      'offset_rows_raw', 'past_L', 'past_L_raw', 'repeated',
                      'offsets64']


def _phased_index(bodies, kind, K, device, N=None, off=0):
    """K4's arguments but the batch: ``bodies`` as [C, N] rows
    (``_probe_rows``) with their seed tables and limb planes, ranked limbs
    (``kind`` 'ranked') or raw, from the plain builders, and the rank and
    present maps of their alphabet: (text, n, sa, tables, limbs, rank,
    present, K, base, depth, bits)."""
    text, n, sa = _probe_rows(bodies, device, N=N, off=off)
    C, Np = text.shape
    pres = np.zeros(256, dtype=bool)
    for b in bodies:
        pres |= np.bincount(b, minlength=256)[:256] > 0
    rank, sigma = S.alphabet_rank(pres)
    bits = S.ranked_bits(sigma) if kind == 'ranked' else None
    assert kind == 'raw' or bits is not None
    base, depth = S.pick_table_params(sigma, max(b.size for b in bodies))
    rk = torch.from_numpy(rank).to(device)
    tables = torch.empty((C, base ** depth + 1), dtype=torch.int32,
                         device=device)
    limbs = torch.empty((C, K * Np), dtype=torch.int32, device=device)
    for i in range(C):
        ni = int(n[i])
        if bits is None:
            pv = S.seed_prefix_plain(text[i], ni, rk, base, depth)
            tables[i] = S.seed_table_from_prefix_plain(pv, sa[i], ni, base,
                                                       depth)
            limbs[i] = S.raw_limb_planes_text_plain(text[i], sa[i], ni,
                                                    depth, K)
        else:
            pv = S.ranked_pack_plain(text[i], ni, rk, bits)
            tables[i] = S.seed_table_plain(pv, sa[i], ni, base, depth, bits)
            limbs[i] = S.ranked_limb_planes_text_plain(text[i], sa[i], ni, rk,
                                                       depth, bits, K)
        del pv
    present = torch.from_numpy(pres.astype(np.int32)).to(device)
    return text, n, sa, tables, limbs, rk, present, K, base, depth, bits


def _phased_traps(bodies, kind, depth, cover, seed):
    """Patterns whose limbs tie with suffixes they do not start: ranked,
    slices past the cover with 'a' (rank r) turned into '`' (absent, so of
    rank r as well) before byte cover & ~15, where the wide compare would
    start; raw, a NUL there, and a row's last bytes followed by NULs past
    the cover (a raw limb packs NUL like a position past n)."""
    m0 = cover & ~15
    pats = []
    for p in _slices(bodies[:1], (cover + 1, cover + 9, 40, 70), 12, seed,
                     misses=False):
        b = bytearray(p)
        at = [q for q in range(depth, min(m0, len(b))) if b[q] == 0x61]
        if kind == 'ranked':
            for q in at:
                b[q] = 0x60
            pats += [p, bytes(b)]
            if at:
                b = bytearray(p)
                b[at[-1]] = 0x60
                pats.append(bytes(b))
        else:
            q = depth + seed % max(1, min(m0, len(b)) - depth)
            b[min(q, len(b) - 1)] = 0
            pats += [p, bytes(b)]
    if kind == 'raw':
        for body in bodies:
            for t in (1, depth, depth + 1, 7, 15):
                if 0 < t <= body.size:
                    tail = body[body.size - t:].tobytes()
                    pats += [tail + b'\x00' * (cover + 5 - t),
                             tail + b'\x00' * (cover - t)]
    return pats


def _probe_phased_case(case, device):
    """K4's arguments (``probe_phased``) for one of ``PROBE_PHASED_CASES``:
    ranked rows (bits 5 and 6, NUL among the bytes of one) and raw rows at
    1, 3 and 8 limbs (the raw cover past 16 at 8), an empty and a one-slot
    row; every pattern length from 0 to the cover + 3 (so every phase count
    and the exact-depth bump) and 16, 17, 32, 33, 48, 64 and 100, near
    misses, row ends; the trap patterns of ``_phased_traps``; deep patterns
    of 100-300 bytes that match many suffixes; rows off the 16-byte
    alignment in a text view off it; lengths past L; one pattern 512
    times; and plane offsets past 2^31 (row 2 of three rows of 2^27 + 16
    slots at 8 limbs)."""
    kind = 'raw' if 'raw' in case else 'ranked'
    K = (1 if case.endswith('k1') else 8 if case.endswith(('k8', '64'))
         or case.startswith(('past_L', 'long_matches_raw')) else 3)
    N, off = None, 0
    if case.startswith('long_matches'):
        bodies = [_repeats(30_011, 7), _repeats(4_099, 8)]
    elif case == 'raw_depth3':  # 128^3 seed buckets and 4 limbs
        bodies = [_limb_row('raw', 2_200_000, 2_200_000, 30, 'cpu')[0]]
        bodies[0][::53] = 0x0A
        K = 4
    elif case == 'offsets64':
        bodies = [_body('nul', 5_000, 1), _body('ranked', 70_001, 2),
                  _body('nul', 4_099, 3)]
        N = (1 << 27) + 16
    else:
        body = 'ranked6' if case.startswith('ranked6') else kind
        bodies = [_body(body, 70_000, 31), _body('nul', 4_099, 32),
                  np.array([0x0A], np.uint8), np.zeros(0, np.uint8)]
        if body != 'ranked':
            bodies[1] = _body(body, 4_099, 32)
        if case.startswith('offset_rows'):
            bodies = bodies[:2]
            N = _pad_len(70_000 + S.PAD_MARGIN) + 5
            off = 3
    args = _phased_index(bodies, kind, K, device, N=N, off=off)
    depth = args[9]
    D = 4 if args[10] is None else S.ranked_limb_bytes(args[10])
    cover = depth + D * K
    pats = [b'', b'\n', b'a', b'\x00', b'\xff']
    if case == 'repeated':
        pats = [bodies[0][123: 123 + cover + 40].tobytes()] * 512
    elif case.startswith('long_matches'):  # traps with wide tie ranges
        pats += _slices(bodies, (cover + 1, 100, 150, 299, 300), 8, 16)
        pats += _phased_traps(bodies, kind, depth, cover, K)
    elif case.startswith('past_L'):  # L = 8, lengths up to the cover
        pats += _slices(bodies, (1, 2, 3, 5, 7, 8), 6, 17)
    else:
        pats.append(b'\x00' * (cover + 2))
        lens = sorted(set(range(1, cover + 4)) | {16, 17, 32, 33, 48, 64, 100})
        pats += _slices(bodies, lens, 2 if K == 8 else 3, K + len(case))
        pats += _row_end_patterns(bodies, (1, 2, depth, cover - 1, cover,
                                           cover + 1))
        pats += _phased_traps(bodies, kind, depth, cover, K)
    packed, lengths = S.pack_patterns(pats)
    if case.startswith('past_L'):  # bytes past L read as 0
        L = packed.shape[1]
        lengths[::5] = L + 1
        lengths[1::5] = min(cover, L + 9)
        lengths[2::5] = cover
    return (*args[:7], torch.from_numpy(packed).to(device),
            torch.from_numpy(lengths).to(device), *args[7:])


#: kPhasedPairsWide in csrc/search_kernels.cu: K4 gives a batch of more
#: (row, pattern) pairs a thread a pair (probe_phased_wide_kernel).
PHASED_PAIRS_WIDE = 1 << 16


@pytest.mark.parametrize('kernel', ['lanes', 'wide'])
@pytest.mark.parametrize('case', PROBE_PHASED_CASES)
def test_probe_phased_matches_plain(cuda, case, kernel):
    """K4 equals its plain version for every (row, pattern), lower bounds
    included (on misses too), in one launch, at the edges of its
    cooperative search and its deep wide compare
    (``_probe_phased_case``); ``'wide'`` repeats the batch past
    ``PHASED_PAIRS_WIDE`` pairs, so the thread-a-pair kernel answers."""
    if case == 'offsets64' and torch.cuda.mem_get_info()[0] < 48 << 30:
        pytest.skip('needs 48 GiB of free device memory')
    args = list(_probe_phased_case(case, cuda))
    C, B = args[0].shape[0], args[7].shape[0]
    if kernel == 'wide':
        reps = PHASED_PAIRS_WIDE // (C * B) + 1
        args[7] = args[7].repeat(reps, 1)
        args[8] = args[8].repeat(reps)
    assert (C * args[7].shape[0] > PHASED_PAIRS_WIDE) == (kernel == 'wide')
    before = kernels.LAUNCHES['probe_phased']
    lo, cnt = S.probe_phased(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES['probe_phased'] == before + 1
    lo_p, cnt_p = S.probe_phased_plain(*args)
    assert torch.equal(lo, lo_p) and torch.equal(cnt, cnt_p)
    assert int((cnt > 0).sum()) > 0
    del args
    torch.cuda.empty_cache()


@pytest.mark.parametrize('cap', [1, 64, 5000])
def test_gather_hit_positions_matches_plain(cuda, cap):
    body = _body('ranked', 200_000, 4)
    N = _pad_len(body.size + S.PAD_MARGIN)
    sa = torch.zeros(N, dtype=torch.int32, device=cuda)
    sa[: body.size] = torch.from_numpy(suffix_array_native(body))
    text = torch.zeros(N, dtype=torch.uint8, device=cuda)
    text[: body.size] = torch.from_numpy(body)
    packed, lengths = S.pack_patterns(_patterns([body], 5))
    lo, cnt = S.probe_bounds(text, body.size, sa,
                             torch.from_numpy(packed).to(cuda),
                             torch.from_numpy(lengths).to(cuda))
    before = kernels.LAUNCHES['gather_hit_positions']
    out = S.gather_hit_positions(sa, lo, cnt, cap)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES['gather_hit_positions'] == before + 1
    assert torch.equal(out, S.gather_hit_positions_plain(sa, lo, cnt, cap))
    assert int((out >= 0).sum()) == int(cnt.clamp(max=cap).sum())


@pytest.mark.parametrize('B, cap, edge', [
    (0, 64, 'none'), (3000, 1, 'zeros'), (3000, 64, 'tail'),
    (3000, 70_000, 'tail'), (3000, 63, 'zeros')])
def test_gather_hit_positions_edges(cuda, B, cap, edge):
    """B = 0, cap 1, 64 and above N, a row width that is no multiple of 4
    (scalar stores), zero counts, and bounds near N - 1 whose counts run
    past the row."""
    rng = np.random.default_rng(B + cap)
    N = 65_536
    sa = torch.from_numpy(rng.permutation(N).astype(np.int32)).to(cuda)
    lo = rng.integers(0, N, B).astype(np.int32)
    cnt = rng.integers(0, 300, B).astype(np.int32)
    if edge == 'zeros':
        cnt[::2] = 0
    if edge == 'tail':
        lo[-4:] = [N - 1, N - 2, N - 3, N - 250]
        cnt[-4:] = [5, 80, 1, 300]
    lo, cnt = (torch.from_numpy(a).to(cuda) for a in (lo, cnt))
    before = kernels.LAUNCHES['gather_hit_positions']
    out = S.gather_hit_positions(sa, lo, cnt, cap)
    torch.cuda.synchronize()
    assert out.shape == (B, min(cap, N))
    assert kernels.LAUNCHES['gather_hit_positions'] == before + (B > 0)
    assert torch.equal(out, S.gather_hit_positions_plain(sa, lo, cnt, cap))


def _group_state(sizes, seed, device, singles=3):
    """An anchored (sa, rank, gs) over groups of the given sizes, each after
    ``singles`` singleton slots, SA order random: one round's input."""
    rng = np.random.default_rng(seed)
    gs = []
    for size in sizes:
        gs.extend(range(len(gs), len(gs) + singles))
        gs.extend([len(gs)] * size)
    gs = np.asarray(gs, dtype=np.int32)
    sa = rng.permutation(gs.size).astype(np.int32)
    rank = np.empty(gs.size, dtype=np.int32)
    rank[sa] = gs
    return [torch.from_numpy(a).to(device) for a in (sa, rank, gs)]


_T = SA.SEG_T
GROUP_STATES = {
    'around_t': ([_T - 1, _T, _T + 1, 2 * _T, 2, 3, 70, 3 * _T, 5], 3),
    'whole_row': ([3 * _T + 7], 0),
    'all_pairs': ([2] * 20_000, 0),
    'many_small': (list(np.random.default_rng(1).integers(2, 600, 3000)), 2),
}


@pytest.mark.parametrize('case', list(GROUP_STATES))
@pytest.mark.parametrize('k', [1, 7])
def test_segmented_round_matches_plain(cuda, case, k):
    """B2's two launches (the tie scan's list, the segmented refine: groups
    of up to SEG_T in shared memory, larger ones by the ordinal-keyed sort)
    against the plain stages at T's real value, bit for bit, with the next
    round's list taken from this one's."""
    sizes, singles = GROUP_STATES[case]
    state = _group_state(sizes, k, cuda, singles)
    plain = [t.clone() for t in state]
    before = dict(kernels.LAUNCHES)
    m, tl = SA.sa_round(*state, k)
    pm, ptl = SA.sa_round_plain(*plain, k)
    torch.cuda.synchronize()
    assert m == pm and torch.equal(tl, ptl)
    for a, b in zip(state, plain):
        assert torch.equal(a, b)
    assert kernels.LAUNCHES['sa_tie_scan'] == before['sa_tie_scan'] + 1
    assert kernels.LAUNCHES['sa_refine_round'] == before['sa_refine_round'] + 1
    m2, tl2 = SA.sa_round(*state, 2 * k, tl)
    pm2, ptl2 = SA.sa_round_plain(*plain, 2 * k, ptl)
    assert m2 == pm2 and torch.equal(tl2, ptl2)
    for a, b in zip(state, plain):
        assert torch.equal(a, b)


@pytest.mark.parametrize('case', ['period2', 'one_group', 'empty', 'one'])
def test_segmented_sa_edge_rows(cuda, case):
    data = {'period2': np.frombuffer(b'ab' * 30_000, np.uint8),
            'one_group': np.full(20_000, 97, np.uint8),
            'empty': np.zeros(0, np.uint8),
            'one': np.array([7], np.uint8)}[case]
    n = data.size
    N = _pad_len(n + S.PAD_MARGIN)
    text = torch.zeros(N, dtype=torch.uint8, device=cuda)
    text[:n] = torch.from_numpy(data.copy())
    sa, ties = SA.segmented_sa(text, n)
    psa, pties = SA.segmented_sa_plain(text, n)
    torch.cuda.synchronize()
    assert ties == pties and torch.equal(sa, psa)
    assert np.array_equal(sa[N - n:].cpu().numpy(), suffix_array_numpy(data))


@pytest.mark.parametrize('depth', [2, 3])
def test_build_bucket_table_matches_plain(cuda, depth):
    body = _body('raw', 300_000, 6)
    N = _pad_len(body.size + S.PAD_MARGIN)
    text = torch.zeros(N, dtype=torch.uint8, device=cuda)
    text[: body.size] = torch.from_numpy(body)
    sa = torch.zeros(N, dtype=torch.int32, device=cuda)
    sa[: body.size] = torch.from_numpy(suffix_array_native(body))
    table = S.build_bucket_table(text, body.size, sa, depth)
    assert torch.equal(table, S.digit_bucket_table_plain(text, sa, body.size,
                                                         depth))
    assert np.array_equal(table.cpu().numpy(), S.build_bucket_table_host(
        body, sa[: body.size].cpu().numpy(), depth))


@pytest.mark.parametrize('n, N', [(1, 8), (70_000, 1 << 17),
                                  (3_000_000, 1 << 22), (1 << 20, 1 << 20)])
def test_rotating_kernels_match_plain(cuda, n, N):
    """B10 on the card: the 3-byte init, passes from the same state (the
    control block, rank and gs after each, sa too: both sorts are stable),
    and the whole doubler with the 6-byte init, bit for bit against their
    plain versions and native SA-IS; the unpadded row has n = N."""
    data = _raw_row(n, n + 1, 'cpu')[0]
    text = torch.zeros(N, dtype=torch.uint8, device=cuda)
    text[:n] = torch.from_numpy(data)
    before = dict(kernels.LAUNCHES)
    init = SA.sa_init3_bytes(text, n)
    plain = SA.sa_init3_bytes_plain(text, n)
    assert all(torch.equal(a, b) for a, b in zip(init, plain))
    state = [t.clone() for t in init]
    k, off, pois = 3, 0, False
    pk, poff, ppois = 3, 0, False
    for _ in range(6):
        k, off, pois, m = SA.sa_rotating_pass(*state, k, off, pois)
        pk, poff, ppois, pm = SA.sa_rotating_pass_plain(*plain, pk, poff,
                                                        ppois)
        assert (k, off, pois, m) == (pk, poff, ppois, pm)
        assert all(torch.equal(a, b) for a, b in zip(state, plain))
    sa, poisoned, ties = SA.segmented_rotating_sa(text, n)
    psa, ppoisoned, pties = SA.segmented_rotating_sa_plain(text, n)
    torch.cuda.synchronize()
    assert not poisoned and not ppoisoned and ties == pties
    assert torch.equal(sa, psa)
    assert np.array_equal(sa[N - n:].cpu().numpy(), suffix_array_native(data))
    for name in ('sa_init3_bytes', 'sa_init_bytes', 'sa_window_scan',
                 'sa_rotating_pass'):
        assert kernels.LAUNCHES[name] > before[name], name


def test_rotating_poisoned_row_and_fallback(cuda, monkeypatch):
    """A row of one repeated byte poisons B10 on the card as in its plain
    version, and a derive index with the threshold lowered re-derives it
    by B9, recorded per row and in the launch counts."""
    text = torch.zeros(4096, dtype=torch.uint8, device=cuda)
    text[:3000] = ord('a')
    _, poisoned, _ = SA.segmented_rotating_sa(text, 3000)
    _, ppoisoned, _ = SA.segmented_rotating_sa_plain(text, 3000)
    assert poisoned and ppoisoned
    monkeypatch.setattr(SA, 'SEGMENTED_MAX_N', 1024)
    data = np.frombuffer(b'aaaaaaab' * 400 + b'\n', np.uint8)
    chunks = [Chunk(data=data, suffix_array=suffix_array_native(data))]
    before = dict(kernels.LAUNCHES)
    idx = DeviceIndex(chunks, device=cuda, mode='derive')
    torch.cuda.synchronize()
    assert idx.sa_poisoned == [True]
    for name in ('sa_window_scan', 'sa_full_init_bytes', 'sa_full_round'):
        assert kernels.LAUNCHES[name] > before[name], name
    assert np.array_equal(idx.sa[0, :data.size].cpu().numpy(),
                          chunks[0].suffix_array)


@pytest.mark.parametrize('n', [1, 8192, (1 << 20) + 3])
def test_scatter_matches_plain(cuda, n):
    rng = np.random.default_rng(n)
    values = torch.from_numpy(rng.integers(0, 1 << 30, size=n,
                                           dtype=np.int32)).to(cuda)
    dests = torch.from_numpy(rng.permutation(n).astype(np.int32)).to(cuda)
    before = kernels.LAUNCHES['scatter']
    out = SA.scatter(values, dests)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES['scatter'] == before + 1
    assert torch.equal(out, SA.scatter_plain(values, dests))


def _scatter_case(case: str):
    """(values, dests, preset out) of a B16 case, numpy int32, made from a
    seed: permutations at the bin and tile edges and of the giant rank
    store's 2^27 slots, and partial covers of a larger ``out`` preset to a
    sentinel whose untouched slots must survive."""
    R, T = SA.SCATTER_BIN_SLOTS, SA.SCATTER_TILE
    rng = np.random.default_rng(len(case))
    perms = {'empty': 0, 'one': 1, 'bin_minus_1': R - 1, 'bin': R,
             'bin_plus_1': R + 1, 'ragged_tile': 3 * T + 5,
             'giant_rank_store': 1 << 27}
    if case in perms:
        n = perms[case]
        dests = rng.permutation(n).astype(np.int32)
        out = np.full(max(n, 1), -7, np.int32)
    elif case == 'partial':
        out = np.full(10_000_019, -7, np.int32)
        dests = rng.choice(out.size, 3_000_000, replace=False)
    elif case == 'one_bin':
        out = np.full(10 * R + 17, -7, np.int32)
        dests = 3 * R + rng.choice(R, 20_000, replace=False)
    elif case == 'descending':
        dests = np.arange(5_000_003, dtype=np.int64)[::-1]
        out = np.full(dests.size, -7, np.int32)
    elif case == 'past_one_pass':
        out = np.full(SA.SCATTER_PASS_SLOTS + R + 3, -7, np.int32)
        dests = rng.choice(out.size, 1 << 22, replace=False)
        dests[:3] = [0, out.size - 1, SA.SCATTER_PASS_SLOTS]
    else:
        raise ValueError(case)
    values = rng.integers(-(1 << 31), 1 << 31, size=dests.size,
                          dtype=np.int64).astype(np.int32)
    return values, dests.astype(np.int32), out


SCATTER_CASES = ('empty', 'one', 'bin_minus_1', 'bin', 'bin_plus_1',
                 'ragged_tile', 'giant_rank_store', 'partial', 'one_bin',
                 'descending', 'past_one_pass')


@pytest.mark.parametrize('case', SCATTER_CASES)
def test_scatter_binned_matches_plain(cuda, case):
    """B16 against ``scatter_plain`` at its edges: no pair and one, the bin
    edges, a tile not whole, the giant rank store's 2^27 permutation, a
    partial cover (slots no dest names keep the sentinel), every dest in
    one bin, dests in descending order and an ``out`` past one pass of
    bins; one counted launch a call."""
    values, dests, preset = _scatter_case(case)
    v, d = torch.from_numpy(values).to(cuda), torch.from_numpy(dests).to(cuda)
    out = torch.from_numpy(preset).to(cuda)
    want = SA.scatter_plain(v, d, out.clone())
    before = kernels.LAUNCHES['scatter']
    assert SA.scatter(v, d, out) is out
    torch.cuda.synchronize()
    assert kernels.LAUNCHES['scatter'] == before + 1
    assert torch.equal(out, want)


@pytest.mark.parametrize('case', ['giant_rank_store', 'partial',
                                  'past_one_pass'])
def test_scatter_binned_index_values_and_dropped_dests(cuda, case):
    """B16 with no values (each dest takes its index, as the giant build's
    finish stores positions by slot) and with every third dest pushed out
    of ``out`` (negative, or past its end: dropped) against
    ``scatter_plain``; one counted launch a call."""
    _, dests, preset = _scatter_case(case)
    d = torch.from_numpy(dests).to(cuda)
    out = torch.from_numpy(preset).to(cuda)
    want = SA.scatter_plain(None, d, out.clone())
    assert SA.scatter(None, d, out) is out
    assert torch.equal(out, want)
    d = d.clone()
    d[::3] = -1 - d[::3]
    d[1::6] += preset.size
    out = torch.from_numpy(preset).to(cuda)
    v = torch.arange(d.shape[0], 0, -1, dtype=torch.int32, device=cuda)
    want = SA.scatter_plain(v, d, out.clone())
    before = kernels.LAUNCHES['scatter']
    SA.scatter(v, d, out)
    assert kernels.LAUNCHES['scatter'] == before + 1
    assert torch.equal(out, want)


def test_scatter_binned_unaligned_views(cuda):
    """B16 on views one element off the 16-byte alignment (the scalar
    loads and stores) against ``scatter_plain``."""
    rng = np.random.default_rng(5)
    n = 1_000_001
    buf_v = torch.from_numpy(rng.integers(0, 1 << 30, size=n + 1,
                                          dtype=np.int32)).to(cuda)
    buf_d = torch.zeros(n + 1, dtype=torch.int32, device=cuda)
    buf_d[1:] = torch.from_numpy(rng.permutation(n + 5)[:n].astype(
        np.int32)).to(cuda)
    buf_o = torch.full((n + 6,), -7, dtype=torch.int32, device=cuda)
    v, d, out = buf_v[1:], buf_d[1:], buf_o[1:]
    want = SA.scatter_plain(v, d, out.clone())
    SA.scatter(v, d, out)
    torch.cuda.synchronize()
    assert torch.equal(out, want) and int(buf_o[0]) == -7


@pytest.mark.parametrize('n', [1, 300, (1 << 20) + 3])
def test_scatter_blocked_matches_plain(cuda, n):
    rng = np.random.default_rng(n + 1)
    values = torch.from_numpy(rng.integers(0, 1 << 30, size=n,
                                           dtype=np.int32)).to(cuda)
    dests = torch.from_numpy(rng.permutation(n).astype(np.int32)).to(cuda)
    out = SA.scatter_blocked(values, dests)
    torch.cuda.synchronize()
    assert torch.equal(out, SA.scatter_plain(values, dests))


@pytest.mark.parametrize('size', [1, 2, 70_000, 3_000_000])
def test_bwt_from_sa_device_matches_plain(cuda, size):
    from pysubstringsearch_tpu_torch.ops import bwt as BWT
    from pysubstringsearch_tpu_torch.ops.native import unbwt_native

    body = _body('nul', size, 8)
    sa_h = suffix_array_native(body)
    text = torch.from_numpy(body).to(cuda)
    sa = torch.from_numpy(sa_h).to(cuda)
    before = kernels.LAUNCHES['bwt_from_sa']
    u, p = BWT.bwt_from_sa_device(text, sa)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES['bwt_from_sa'] == before + 1
    u_p, p_p = BWT.bwt_from_sa_device_plain(text, sa)
    assert torch.equal(u, u_p) and int(p) == int(p_p) and p.dim() == 0
    u_h, p_h = BWT.bwt_from_sa(body, sa_h)
    assert np.array_equal(u.cpu().numpy(), u_h) and int(p) == p_h
    if size > 1:
        assert np.array_equal(unbwt_native(u.cpu().numpy(), int(p)), body)


@pytest.mark.parametrize('n', [1, 2, 16, 17, 4_099, 1 << 20, (1 << 20) + 5])
@pytest.mark.parametrize('where', ['first', 'last', 'middle'])
@pytest.mark.parametrize('off', [0, 1])
def test_bwt_from_sa_device_primary_anywhere(cuda, n, where, off):
    """B13 on a permutation of [0, n) whose suffix 0 sits in the first
    slot, the last or a middle one (the chunk of the byte shift that holds
    i0), against its plain version and the host transform; text and SA as
    views ``off`` elements into their buffers (the scalar paths), at
    lengths that are not multiples of 16."""
    from pysubstringsearch_tpu_torch.ops import bwt as BWT

    rng = np.random.default_rng(n + off)
    body = rng.integers(0, 256, size=n, dtype=np.uint8)
    perm = rng.permutation(n).astype(np.int32)
    i0 = {'first': 0, 'last': n - 1, 'middle': (n - 1) // 2 + 7 * (n > 20)}[
        where]
    j = int(np.nonzero(perm == 0)[0][0])
    perm[j], perm[i0] = perm[i0], 0
    tbuf = torch.zeros(n + off, dtype=torch.uint8, device=cuda)
    sbuf = torch.zeros(n + off, dtype=torch.int32, device=cuda)
    text, sa = tbuf[off:], sbuf[off:]
    text.copy_(torch.from_numpy(body))
    sa.copy_(torch.from_numpy(perm))
    u, p = BWT.bwt_from_sa_device(text, sa)
    u_p, p_p = BWT.bwt_from_sa_device_plain(text, sa)
    torch.cuda.synchronize()
    assert int(p) == i0 + 1 == int(p_p) and torch.equal(u, u_p)
    u_h, p_h = BWT.bwt_from_sa(body, perm)
    assert np.array_equal(u.cpu().numpy(), u_h) and int(p) == p_h


def test_bwt_from_sa_device_in_several_passes(cuda):
    """B13 on a row long enough for several gather passes (each takes the
    slots whose source byte lies in one slice of the text), suffix 0 in a
    middle slot, against its plain version."""
    from pysubstringsearch_tpu_torch.ops import bwt as BWT

    n = (100 << 20) + 5
    g = torch.Generator(device=cuda)
    g.manual_seed(11)
    text = torch.randint(0, 256, (n,), generator=g, device=cuda,
                         dtype=torch.uint8)
    sa = torch.randperm(n, generator=g, device=cuda).to(torch.int32)
    u, p = BWT.bwt_from_sa_device(text, sa)
    u_p, p_p = BWT.bwt_from_sa_device_plain(text, sa)
    torch.cuda.synchronize()
    assert int(p) == int(p_p) and torch.equal(u, u_p)


def _seg_t_body(rng) -> np.ndarray:
    """Random lowercase text with 4096 copies of 'XYZD' and 4097 of 'QRSD',
    each followed by 6 random lowercase bytes: two top-bits buckets of B1b
    (cut 32: the first 3 bytes and the top bits of the 4th) of exactly
    SEG_T and SEG_T + 1 members."""
    parts = []
    for marker, copies in ((b'XYZD', SA.SEG_T), (b'QRSD', SA.SEG_T + 1)):
        tails = rng.integers(97, 123, size=(copies, 6), dtype=np.uint8)
        parts += [marker + t.tobytes() for t in tails]
    rng.shuffle(parts)
    filler = rng.integers(97, 123, size=400_000, dtype=np.uint8).tobytes()
    return np.frombuffer(b''.join(parts) + filler, np.uint8).copy()


def _sample_miss_body(rng) -> np.ndarray:
    """Periods of 17 bytes, 3 random capitals then 14 'a's: the positions
    the init samples (every 17th) start unique-ish buckets, the others
    mostly one bucket of 'aaaa', so the estimate says small and the count
    says more than the hybrid path's cap."""
    rows = np.full((60_000, 17), ord('a'), np.uint8)
    rows[:, :3] = rng.integers(65, 91, size=(60_000, 3), dtype=np.uint8)
    return rows.reshape(-1)


def _init_case(case, device):
    """(text [N] on device, n, rank map or None, bits or None) of a case:
    a ranked row runs B1, any other B1b."""
    rng = np.random.default_rng(len(case))
    if case == 'ranked_words':
        _, text, n, rank, bits = _word_row(3_000_000, 5, device)
        return text, n, rank, bits
    if case == 'ranked6':
        data = _body('ranked6', 2_000_000, 3)
    elif case == 'raw_words':
        return _raw_row(1 << 24, 7, device)[1:] + (None, None)
    elif case == 'raw_random':
        return _raw_row(1 << 20, 8, device)[1:] + (None, None)
    elif case == 'utf16':
        data = _digit_body(4_000_000, 4)
    elif case == 'one_bucket':
        data = np.full(300_000, ord('e'), np.uint8)
    elif case == 'seg_t':
        data = _seg_t_body(rng)
    elif case == 'sample_miss':
        data = _sample_miss_body(rng)
    else:  # 'empty', 'one', 'margin'
        data = rng.integers(1, 256, size={'empty': 0, 'one': 1,
                                          'margin': 65_530}[case],
                            dtype=np.uint8)
    n = data.size
    N = 1 << 16 if case == 'margin' else _pad_len(n + S.PAD_MARGIN)
    text = torch.zeros(N, dtype=torch.uint8, device=device)
    text[:n] = torch.from_numpy(data)
    if case == 'ranked6':
        pres = np.bincount(data, minlength=256)[:256] > 0
        rank, sigma = S.alphabet_rank(pres)
        return text, n, torch.from_numpy(rank).to(device), \
            S.ranked_bits(sigma)
    return text, n, None, None


#: The path the device picks where the case decides it: 1 the hybrid one,
#: 2 the full sort (the estimate), 3 the full sort after the hybrid path's
#: cap.
INIT_AUTO_PATH = {'utf16': 2, 'one_bucket': 2, 'sample_miss': 3,
                  'seg_t': 1, 'ranked_words': 1, 'raw_random': 1,
                  'empty': 1, 'one': 1, 'margin': 1}


@pytest.mark.parametrize('case', ['ranked_words', 'ranked6', 'raw_words',
                                  'raw_random', 'utf16', 'one_bucket',
                                  'seg_t', 'sample_miss', 'empty', 'one',
                                  'margin'])
def test_anchored_init_paths_match_plain(cuda, case):
    """B1 and B1b on the card, on the path the device picks, bit for bit
    against their plain versions (a stable sort of the whole key), with
    the path each took: the cases reach all three paths."""
    text, n, rank, bits = _init_case(case, cuda)
    stats = torch.full((3,), -1, dtype=torch.int32, device=cuda)
    name = 'sa_init_bytes' if bits is None else 'sa_init_ranked'
    before = kernels.LAUNCHES[name]
    if bits is None:
        got = SA.sa_init_bytes(text, n, stats=stats)
        want = SA.sa_init_bytes_plain(text, n)
    else:
        got = SA.sa_init_ranked(text, n, rank, bits, stats=stats)
        want = SA.sa_init_ranked_plain(text, n, rank, bits)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    taken, est, large = stats.tolist()
    assert taken in (1, 2, 3), (taken, est, large)
    if taken == 2:
        assert large == 0
    if case in INIT_AUTO_PATH:
        assert taken == INIT_AUTO_PATH[case], (taken, est, large)
    if case == 'seg_t':
        _, _, bs = SA.bucket_split_plain(SA._byte_key(text.cpu(), n), n,
                                         SA.BYTE_KEY_BITS,
                                         SA.INIT_CUT_BYTES)
        sizes = set(torch.bincount(bs).tolist())
        assert {SA.SEG_T, SA.SEG_T + 1} <= sizes


@pytest.mark.parametrize('name', ['sa_init_ranked', 'sa_init_bytes',
                                  'sa_init3_bytes'])
def test_anchored_inits_on_offset_views(cuda, name):
    """B1, B1b and B10's init read their text through 16-byte loads only
    where it is 16-byte aligned: a row that is a view one byte into its
    buffer gives the plain versions' result, bit for bit."""
    data, _, n, rank, bits = _word_row(300_000, 11, 'cpu')
    N = _pad_len(n + S.PAD_MARGIN)
    buf = torch.zeros(N + 1, dtype=torch.uint8, device=cuda)
    buf[1:n + 1] = torch.from_numpy(data.copy())
    text = buf[1:]
    assert text.data_ptr() % 16 != 0
    if name == 'sa_init_ranked':
        rank = rank.to(cuda)
        got = SA.sa_init_ranked(text, n, rank, bits)
        want = SA.sa_init_ranked_plain(text, n, rank, bits)
    else:
        got = getattr(SA, name)(text, n)
        want = getattr(SA, name + '_plain')(text, n)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# ---- B14g: one row's B9 split over a mesh ---------------------------------

def _giant_launches():
    return {k: kernels.LAUNCHES[k] for k in (
        'giant_byte_keys', 'giant_round_keys', 'giant_cuts',
        'giant_partition', 'giant_flags', 'giant_relabel', 'giant_merge')}


def _merge_case(S, m, layout, bits, seed, device):
    """(keys int64, positions int32, run lengths) of S runs of m pairs as a
    shard receives them: each sorted by (key, position), positions rising
    from run to run.  ``layout``: 'random' cuts, 'sparse' (runs of 0 and 1
    pairs, the rest in the middle run), 'one_run' (every pair in the
    middle run); keys of ``bits`` bits, or all equal at 0."""
    rng = np.random.default_rng([S, m, bits, seed])
    if layout == 'random':
        cuts = np.sort(rng.integers(0, m + 1, size=S - 1))
        lengths = np.diff(np.concatenate([[0], cuts, [m]])).tolist()
    else:
        lengths = [0] * S
        if layout == 'sparse':
            lengths = [int(x) for x in rng.integers(0, 2, size=S)]
            lengths[S // 2] = 0
            lengths[S // 2] = max(m - sum(lengths), 0)
            while sum(lengths) > m:
                lengths[lengths.index(1)] = 0
        else:
            lengths[S // 2] = m
    g = torch.Generator(device='cpu').manual_seed(int(rng.integers(1 << 30)))
    if bits:
        keys = torch.randint(0, 1 << bits, (m,), generator=g,
                             dtype=torch.int64)
        keys[: min(m, 3)] = (1 << bits) - 1  # the top bit in use
    else:
        keys = torch.zeros(m, dtype=torch.int64)
    keys = keys.to(device)
    run = torch.repeat_interleave(
        torch.arange(S, device=device),
        torch.tensor(lengths, dtype=torch.int64, device=device))
    order = torch.sort(keys, stable=True).indices
    order = order[torch.sort(run[order], stable=True).indices]
    return keys[order], order.to(torch.int32), lengths


@pytest.mark.parametrize('m', [0, 1, SA.GIANT_MERGE_TILE - 1,
                               SA.GIANT_MERGE_TILE, SA.GIANT_MERGE_TILE + 1])
@pytest.mark.parametrize('S', [1, 2, 4, 7, 64, 256])
def test_giant_merge_matches_plain(cuda, S, m):
    """The merge against its plain version (a stable ``torch.sort``) at
    the segment capacity's edges, S from 1 (no round) to 256 (eight rounds
    of pairwise merges), 60-bit keys, random cuts (empty runs included);
    one counted launch a call."""
    keys, pos, lengths = _merge_case(S, m, 'random', 60, 0, cuda)
    want = SA.giant_merge_plain(keys, pos, lengths)
    before = kernels.LAUNCHES['giant_merge']
    got = SA.giant_merge(keys, pos, lengths)
    assert kernels.LAUNCHES['giant_merge'] == before + 1
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize('case', [
    'sparse_s64', 'sparse_s256', 'one_run_s4', 'one_run_s256',
    'receive_2b_s', 'equal_s4', 'equal_s256', 'bits48', 'bits60', 's17',
    'big'])
def test_giant_merge_edges_match_plain(cuda, case):
    """The merge against its plain version where it could go wrong: runs of
    0 and 1 pairs around one large run, every pair in one run (S = 4 and
    256), a receive of 2B + S pairs (B = 2^20, S = 4), all keys equal (the
    order from the run alone, as in every early round of ``abab...``), 48-
    and 60-bit keys, 17 runs (a group of one run in every round) and 2^27
    pairs, the 512 Mi row's shard at S = 4."""
    S, m, layout, bits = {
        'sparse_s64': (64, 50_000, 'sparse', 60),
        'sparse_s256': (256, 70_001, 'sparse', 60),
        'one_run_s4': (4, 100_003, 'one_run', 60),
        'one_run_s256': (256, 100_003, 'one_run', 60),
        'receive_2b_s': (4, (2 << 20) + 4, 'random', 60),
        'equal_s4': (4, 1 << 20, 'random', 0),
        'equal_s256': (256, 1 << 20, 'random', 0),
        'bits48': (4, 1 << 22, 'random', 48),
        'bits60': (4, 1 << 22, 'random', 60),
        's17': (17, 300_007, 'random', 60),
        'big': (4, 1 << 27, 'random', 60),
    }[case]
    keys, pos, lengths = _merge_case(S, m, layout, bits, 1, cuda)
    want = SA.giant_merge_plain(keys, pos, lengths)
    before = kernels.LAUNCHES['giant_merge']
    got = SA.giant_merge(keys, pos, lengths)
    assert kernels.LAUNCHES['giant_merge'] == before + 1
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def _relabel_list(m, spread, seed, W=31, base=0):
    """A shard's merged list of m round keys as the relabel receives it:
    old groups of 2-9 members (the tied ones) at group starts g that skip
    0 to ``spread`` settled slots before each, sorted by key, the low bits
    tying within a group (``spread`` 0: one group, all keys equal).  The
    first group starts at ``base``, the list's offset: a group's start is
    never below its first member's list index, as in the build."""
    rng = np.random.default_rng([m, spread, seed])
    if spread == 0:
        return np.full(m, (5 + base) << W, np.int64)
    sizes = rng.integers(2, 10, size=m // 2 + 1)
    gaps = rng.integers(0, spread + 1, size=sizes.size)
    starts = base + np.cumsum(gaps) + np.concatenate(
        [[0], np.cumsum(sizes)[:-1]])
    g = np.repeat(starts, sizes)[:m]
    low = rng.integers(1, 4, size=m)
    return np.sort((g.astype(np.int64) << W) | low)


def _relabel_shards(keys, S, seed):
    """The list cut at S - 1 random points (some shards empty), with each
    shard's list offset, predecessor and successor key."""
    m = keys.shape[0]
    rng = np.random.default_rng([S, seed])
    cuts = np.sort(rng.integers(0, m + 1, size=S - 1))
    if S > 2:
        cuts[S // 2] = cuts[S // 2 - 1]  # an empty shard
    edges = [0] + cuts.tolist() + [m]
    shards = []
    for s in range(S):
        lo, hi = edges[s], edges[s + 1]
        pred = int(keys[lo - 1]) if lo > 0 else None
        succ = int(keys[hi]) if hi < m else None
        shards.append((keys[lo:hi], lo, pred, succ))
    return shards


@pytest.mark.parametrize('layout', ['groups', 'one_group', 'wide_gaps'])
@pytest.mark.parametrize('m', [0, 1, 4095, 4096, 4097, 1 << 24])
def test_giant_relabel_matches_plain(cuda, m, layout):
    """The relabel's look-back pass and the flags against their plain
    versions at the 4096-pair tile's edges and 2^24 pairs: tied old groups
    among settled slots, one group of equal keys (every early round of
    ``abab``), and wide gaps; one counted launch each."""
    spread = {'groups': 2, 'one_group': 0, 'wide_gaps': 1000}[layout]
    keys = torch.from_numpy(_relabel_list(m, spread, 1)).to(cuda)
    real_lo = int(keys[m // 3]) if m else 0
    before = kernels.LAUNCHES['giant_relabel']
    flags_before = kernels.LAUNCHES['giant_flags']
    st = SA.giant_flags(keys, 0, None, None, 31, real_lo)
    got = SA.giant_relabel(keys, 0, None, None, 31, -1, -1)
    assert kernels.LAUNCHES['giant_relabel'] == before + 1
    assert kernels.LAUNCHES['giant_flags'] == flags_before + 1
    assert torch.equal(st, SA.giant_flags_plain(keys, 0, None, None, 31,
                                                real_lo))
    assert torch.equal(got, SA.giant_relabel_plain(keys, 0, None, None, 31,
                                                   -1, -1))


@pytest.mark.parametrize('S', [4, 64, 256])
def test_giant_relabel_over_shards(cuda, S):
    """A list of 2^24 pairs cut over S shards (one empty, old groups across
    the cuts): every shard's flags, then its relabel with the carries of
    the shards before it, against the plain versions, and the shards'
    group starts joined against the plain relabel of the whole list."""
    keys = torch.from_numpy(_relabel_list(1 << 24, 3, S)).to(cuda)
    real_lo = int(keys[1 << 22])
    shards = _relabel_shards(keys, S, 2)
    stats = []
    for kk, off, pred, succ in shards:
        st = SA.giant_flags(kk, off, pred, succ, 31, real_lo)
        assert torch.equal(st, SA.giant_flags_plain(kk, off, pred, succ, 31,
                                                    real_lo))
        stats.append(st.tolist())
    parts = []
    for s, (kk, off, pred, succ) in enumerate(shards):
        ca = max([-1] + [x[0] for x in stats[:s]])
        cb = max([-1] + [x[1] for x in stats[:s]])
        got = SA.giant_relabel(kk, off, pred, succ, 31, ca, cb)
        assert torch.equal(got, SA.giant_relabel_plain(kk, off, pred, succ,
                                                       31, ca, cb))
        parts.append(got)
    whole = SA.giant_relabel_plain(keys, 0, None, None, 31, -1, -1)
    assert torch.equal(torch.cat(parts), whole)
    assert sum(x[2] for x in stats) == int(SA.giant_flags_plain(
        keys, 0, None, None, 31, real_lo)[2])


@pytest.mark.parametrize('m', [SA.GIANT_MAX_SHARDS * 16 + 3, (1 << 22) + 5])
def test_giant_relabel_off_alignment(cuda, m):
    """Keys read through a view one element off the 16-byte alignment (the
    scalar loads and stores)."""
    buf = torch.from_numpy(_relabel_list(m + 1, 2, 7, base=5)).to(cuda)
    keys = buf[1:]
    assert keys.data_ptr() % 16
    assert torch.equal(SA.giant_relabel(keys, 5, int(buf[0]), None, 31, 3, 4),
                       SA.giant_relabel_plain(keys, 5, int(buf[0]), None, 31,
                                              3, 4))


def _marked_block(m, share, seed, device):
    """A rank block of m group starts, about ``share`` of them unsettled
    (the sign bit set)."""
    g = torch.Generator(device='cpu').manual_seed(seed)
    rank = torch.randint(0, 1 << 30, (m,), generator=g, dtype=torch.int32)
    tied = torch.rand(m, generator=g) < share
    rank[tied] |= SA.GIANT_UNSETTLED
    return rank.to(device)


@pytest.mark.parametrize('share', [0.0, 0.4, 1.0])
@pytest.mark.parametrize('m', [1, 4095, 4096, 4097, 1 << 24])
def test_giant_round_keys_match_plain(cuda, m, share):
    """The compacting round keys' look-back pass against the plain mask at
    the 4096-position tile's edges and 2^24 positions, with no, 40% and
    every position unsettled, the shifted ranks cut short (marked ones
    among them); the device's count equals the host's; one counted
    launch."""
    rank = _marked_block(m, share, m, cuda)
    r2 = _marked_block(max(m - 777, 0), 0.5, m + 1, cuda)
    live = int((rank < 0).sum())
    want = SA.giant_round_keys_plain(rank, r2, 31, 12345)
    before = kernels.LAUNCHES['giant_round_keys']
    got = SA.giant_round_keys(rank, r2, 31, 12345, live)
    assert kernels.LAUNCHES['giant_round_keys'] == before + 1
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert got[2].tolist() == [live]


def test_giant_round_keys_off_alignment(cuda):
    """Rank and shifted-rank views off the 16-byte alignment, and a count
    the host expects short of the device's (only that many written)."""
    buf = _marked_block((1 << 20) + 1, 0.5, 3, cuda)
    rank, r2 = buf[1:], buf[7:]
    assert rank.data_ptr() % 16
    live = int((rank < 0).sum())
    want = SA.giant_round_keys_plain(rank, r2, 31, 0)
    got = SA.giant_round_keys(rank, r2, 31, 0, live)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    short = SA.giant_round_keys(rank, r2, 31, 0, live - 5)
    assert torch.equal(short[0], want[0][: live - 5])
    assert short[2].tolist() == [live]


@pytest.mark.parametrize('S', [4, 8])
def test_giant_kernels_match_plain(cuda, S):
    """Kernels (a)-(c) of B14g against their plain versions on 2^24 keys:
    the byte and round keys of the first and last shard of a 2^24 row (the
    last one's halo and shifted ranks cut at the row's end), the cuts of a
    sorted shard at S - 1 (key, position) splitters, the partition by owner
    of 2^24 (position, group start) pairs, and the flags of 2^24 sorted
    keys with ties, with and without a predecessor."""
    N = 1 << 24
    n = N - 1000
    B = N // S
    rng = np.random.default_rng(S)
    row = torch.zeros(N, dtype=torch.uint8, device=cuda)
    row[:n] = torch.from_numpy(_body('ranked', n, S)).to(cuda)
    for s in (0, S - 1):
        text = row[s * B: (s + 1) * B]
        halo = row[(s + 1) * B: (s + 1) * B + 5]
        got = SA.giant_byte_keys(text, halo, s * B, n)
        want = SA.giant_byte_keys_plain(text, halo, s * B, n)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        rank = torch.from_numpy(rng.integers(0, N, size=B).astype(
            np.int32)).to(cuda)
        rank[::3] |= SA.GIANT_UNSETTLED
        r2 = rank[: B - 777 * s].flip(0).contiguous()
        live = int((rank < 0).sum())
        got = SA.giant_round_keys(rank, r2, 25, s * B, live)
        want = SA.giant_round_keys_plain(rank, r2, 25, s * B)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    keys, vals, _ = SA.giant_round_keys(rank, r2, 25, (S - 1) * B, live)
    keys = keys >> 20  # ties
    SA.radix_sort_pairs(keys, vals, 50)
    pick = torch.randint(0, keys.shape[0], (S - 1,), device=cuda)
    skeys, spos = keys[pick].sort().values, vals[pick] + 1
    cuts = SA.giant_cuts(keys, vals, skeys, spos)
    assert torch.equal(cuts, SA.giant_cuts_plain(keys, vals, skeys, spos))
    m = 1 << 24
    pos = torch.randperm(N, device=cuda)[:m].to(torch.int32)
    gs = torch.randint(-N, N, (m,), device=cuda, dtype=torch.int32)
    live = torch.empty(S, dtype=torch.int32, device=cuda)
    got = SA.giant_partition(pos, gs, B, S, live=live)
    want = SA.giant_partition_plain(pos, gs, B, S)
    assert all(torch.equal(a, b) for a, b in zip(got, want[:3]))
    assert torch.equal(live, want[3])
    keys = torch.from_numpy(_relabel_list(m, 2, S, 25, 777)).to(cuda)
    for pred, succ in ((None, None), (int(keys[0]), int(keys[-1])),
                       (int(keys[0]) - 1, int(keys[-1]) + 1)):
        st = SA.giant_flags(keys, 777, pred, succ, 25, int(keys[m // 3]))
        assert torch.equal(st, SA.giant_flags_plain(keys, 777, pred, succ,
                                                    25, int(keys[m // 3])))
        got = SA.giant_relabel(keys, 777, pred, succ, 25, 5, 900)
        assert torch.equal(got, SA.giant_relabel_plain(keys, 777, pred, succ,
                                                       25, 5, 900))


@pytest.mark.parametrize('case', ['splitters255', 'tie_run'])
def test_giant_cuts_edges_match_plain(cuda, case):
    """The cuts' 256-ary search against its plain version: 2^24 pairs in
    (key, position) order with 255 splitters (the first below every pair,
    the last above), and a run of 5000 equal keys, longer than a round's
    256 probes, with splitters inside it, at its ends and beside them."""
    rng = np.random.default_rng(17)
    if case == 'splitters255':
        m = 1 << 24
        raw = torch.from_numpy(rng.integers(0, 1 << 20, size=m)).to(cuda)
        keys, order = torch.sort(raw, stable=True)
        vals = order.to(torch.int32)
        pick = torch.from_numpy(np.sort(rng.integers(0, m, size=255))).to(
            cuda)
        skeys = keys[pick].clone()
        spos = (vals[pick] + torch.from_numpy(
            rng.integers(-1, 2, size=255).astype(np.int32)).to(cuda))
        skeys[0], skeys[-1] = -1, 1 << 21
    else:
        keys = torch.cat([torch.full((1000,), 1), torch.full((5000,), 7),
                          torch.full((1000,), 9)]).to(cuda)
        vals = torch.cat([torch.arange(1000), torch.arange(0, 10000, 2),
                          torch.arange(1000)]).to(cuda, torch.int32)
        sp = [-1, 0, 1, 2, 511, 512, 513, 4999, 5000, 9998, 9999, 10 ** 6]
        skeys = torch.tensor([7] * len(sp) + [1, 9, 0, 10], device=cuda)
        spos = torch.tensor(sp + [10 ** 6, -1, 5, 0], dtype=torch.int32,
                            device=cuda)
    before = kernels.LAUNCHES['giant_cuts']
    cuts = SA.giant_cuts(keys, vals, skeys, spos)
    assert kernels.LAUNCHES['giant_cuts'] == before + 1
    assert torch.equal(cuts, SA.giant_cuts_plain(keys, vals, skeys, spos))
    out = torch.empty((2, skeys.shape[0]), dtype=torch.int64, device=cuda)
    SA.giant_cuts(keys, vals, skeys, spos, out=out[1])
    assert torch.equal(out[1], cuts)


@pytest.mark.parametrize('layout', ['random', 'one_owner', 'offset'])
@pytest.mark.parametrize('S', [1, 4, 8, 256])
def test_giant_partition_edges_match_plain(cuda, S, layout):
    """The two-pass partition against its plain version on m = 2^24 - 1
    pairs (off the 4096-pair tile) with B = 2^31 / S - 3, not a power of
    two: positions over every block, all in one owner's block, or read
    from views one element off the 16-byte alignment (the histogram's
    scalar loads); group starts marked unsettled and not, counted by
    owner."""
    rng = np.random.default_rng(S)
    m = (1 << 24) - 1
    B = (1 << 31) // S - 3
    if layout == 'one_owner':
        pos = (S // 2) * B + rng.integers(0, B, size=m)
    else:
        pos = rng.integers(0, S * B, size=m)
    gs = rng.integers(-(1 << 30), 1 << 30, size=m)
    pos = torch.from_numpy(pos.astype(np.int32)).to(cuda)
    gs = torch.from_numpy(gs.astype(np.int32)).to(cuda)
    if layout == 'offset':
        pos = torch.cat([pos[:1], pos])[1:]
        gs = torch.cat([gs[:1], gs])[1:]
        assert pos.data_ptr() % 16 and gs.data_ptr() % 16
    live = torch.empty(S, dtype=torch.int32, device=cuda)
    before = kernels.LAUNCHES['giant_partition']
    got = SA.giant_partition(pos, gs, B, S, live=live)
    assert kernels.LAUNCHES['giant_partition'] == before + 1
    want = SA.giant_partition_plain(pos, gs, B, S)
    assert all(torch.equal(a, b) for a, b in zip(got, want[:3]))
    assert torch.equal(live, want[3])
    if layout == 'one_owner':
        assert int(got[2][S // 2]) == m


def test_giant_partition_of_nothing(cuda):
    """m = 0: counts of zero, empty outputs, one launch."""
    empty = torch.empty(0, dtype=torch.int32, device=cuda)
    live = torch.full((5,), -1, dtype=torch.int32, device=cuda)
    p, g, tot = SA.giant_partition(empty, empty, 37, 5, live=live)
    assert p.shape == g.shape == (0,) and tot.tolist() == [0] * 5
    assert live.tolist() == [0] * 5


@pytest.mark.parametrize('case', ['ranked_8mib', 'period2', 'n_eq_N',
                                  'tiny', 'uneven', 'utf16'])
def test_giant_build_on_one_card(cuda, case):
    """B14g on four placements of one card (eight for the tiny row) equals
    B9 (``sa_full_doubling``) on the card, pad slots included, and
    launches every kernel of its path; after the init its sorts take only
    the tied positions (the uneven row: random bytes, all settled by the
    init, then ``ab``; the UTF-16 row: NUL bytes up to n)."""
    from pysubstringsearch_tpu_torch.parallel import mesh as M
    from pysubstringsearch_tpu_torch.parallel import sharded

    data = {'ranked_8mib': lambda: _body('ranked', (8 << 20) - 300, 5),
            'period2': lambda: np.frombuffer(b'ab' * (1 << 18), np.uint8),
            'n_eq_N': lambda: _body('raw', 1 << 16, 6),
            'tiny': lambda: np.frombuffer(b'abaab', np.uint8),
            'uneven': lambda: np.concatenate([
                _body('raw', 1 << 20, 7),
                np.frombuffer(b'ab' * (3 << 19), np.uint8)]),
            'utf16': lambda: np.frombuffer(
                _body('ranked', 1 << 19, 8).tobytes().decode(
                    'latin-1').encode('utf-16-le'), np.uint8)}[case]()
    n = data.size
    N = _pad_len(n) if case != 'tiny' else 8
    text = torch.zeros(N, dtype=torch.uint8, device=cuda)
    text[:n] = torch.from_numpy(data.copy()).to(cuda)
    S = 8 if case == 'tiny' else 4
    build = sharded.make_giant_chunk_build(M.make_mesh(['cuda:0'] * S))
    before = _giant_launches()
    got = build(text, n)
    after = _giant_launches()
    assert got.device == text.device and got.shape == (N,)
    assert torch.equal(got, SA.sa_full_doubling(text, n))
    for name in after:  # a row settled by the init sends no ranks home
        if build.stats['rounds'] or name not in ('giant_round_keys',
                                                 'giant_partition'):
            assert after[name] > before[name], name
    st = build.stats
    assert all(r <= b <= st['recv_bound']
               for r, b in zip(st['max_recv'], st['round_bound']))
    assert st['sorted'][0] == N and all(
        a >= b for a, b in zip(st['sorted'], st['sorted'][1:]))
    if case == 'uneven':  # the random megabyte settles in the init
        assert st['sorted'][1] < N - 1_000_000
    if case == 'ranked_8mib':
        assert np.array_equal(got[N - n:].cpu().numpy(),
                              suffix_array_native(data))


def test_trace_to_records_the_probe_kernel(cuda, tmp_path):
    """``trace_to`` around one ``DeviceIndex.probe`` writes a trace that
    names the probe's kernel."""
    import glob
    import json

    from pysubstringsearch_tpu_torch.utils.profiling import trace_to

    bodies = [_body('ranked', 30_000, 3)]
    chunks = [Chunk(data=b, suffix_array=suffix_array_numpy(b))
              for b in bodies]
    idx = DeviceIndex(chunks, device=cuda, mode='derive')
    packed, lengths = S.pack_patterns(_patterns(bodies, 4, 50))
    idx.probe(packed, lengths)
    torch.cuda.synchronize()
    with trace_to(str(tmp_path)):
        idx.probe(packed, lengths)
        torch.cuda.synchronize()
    (path,) = glob.glob(str(tmp_path / '*.json'))
    with open(path) as f:
        names = {e.get('name', '') for e in json.load(f)['traceEvents']}
    assert any('probe_phased' in name for name in names), sorted(names)[:50]


@pytest.mark.parametrize('N', [1, 5, 4096, 4099, (1 << 22) + 3])
@pytest.mark.parametrize('at', ['0', '1', '2', '3', 'N-1', 'N'])
@pytest.mark.parametrize('views', [(0, 0), (1, 0), (0, 3)])
def test_roll_front_matches_plain(cuda, N, at, views):
    """R, the derived SA's roll, against its plain version: n = 0, 1, 2, 3
    (every (N - n) mod 4 on each N), N - 1 and N, on row lengths that are
    and are not a multiple of 4, with the source or the output a view off
    its 16-byte alignment."""
    n = min(N, int(at) if at.isdigit() else N - int(at[2:] or 0))
    a, b = views
    src = torch.randint(-2**31, 2**31 - 1, (N + a,), dtype=torch.int32,
                        device=cuda)[a:]
    out = torch.full((N + b,), -7, dtype=torch.int32, device=cuda)[b:]
    before = kernels.LAUNCHES['sa_roll_front']
    got = SA.sa_roll_front(src, n, out=out)
    assert got.data_ptr() == out.data_ptr()
    assert kernels.LAUNCHES['sa_roll_front'] == before + 1
    assert torch.equal(out, SA.sa_roll_front_plain(src, n))
    assert torch.equal(SA.sa_roll_front(src, n), torch.roll(src, n - N))


def _kind_body(kind, size, seed):
    """A body of the index kind: ranked, raw (every byte but NUL) or digit
    (the raw body with every 89th byte NUL)."""
    body = _body('raw' if kind == 'digit' else kind, size, seed)
    if kind == 'digit':
        body[::89] = 0
    return body


@pytest.mark.parametrize('mode', ['derive', 'upload'])
@pytest.mark.parametrize('kind', ['ranked', 'raw', 'digit'])
def test_sharded_index_on_two_placements(cuda, kind, mode):
    """``ShardedIndex`` over two placements of the card: one probe launch
    a placement, one part on the first, whose bounds read back equal
    ``probe`` (on the patterns without NUL for the raw kind, which
    ``probe`` zeroes on the host) and the CPU sharded index's."""
    bodies = [_kind_body(kind, m, s) for s, m in enumerate((30_000, 777,
                                                            52_000))]
    chunks = [Chunk(data=b, suffix_array=suffix_array_numpy(b))
              for b in bodies]
    gpu = ShardedIndex(chunks, [cuda, cuda], mode=mode)
    cpu = ShardedIndex(chunks, ['cpu', 'cpu'], mode=mode)
    assert gpu.kind == kind and gpu.num_chunks % 2 == 0
    pats = _patterns(bodies, 2)
    packed, lengths = S.pack_patterns(pats)
    name = 'probe_limbs' if kind == 'digit' else 'probe_phased'
    before = kernels.LAUNCHES[name]
    (members, lo_d, cnt_d), = gpu.probe_device_parts(packed, lengths)
    assert kernels.LAUNCHES[name] == before + 2
    assert lo_d.device == torch.empty(0, device=gpu.device).device
    assert lo_d.shape == (gpu.num_chunks, len(pats))
    lo, cnt = gpu.probe(packed, lengths)
    keep = [b'\x00' not in p for p in pats] if kind == 'raw' else slice(None)
    np.testing.assert_array_equal(cnt_d.cpu().numpy()[:, keep], cnt[:, keep])
    np.testing.assert_array_equal(lo_d.cpu().numpy()[:, keep], lo[:, keep])
    lo_c, cnt_c = cpu.probe(packed, lengths)
    np.testing.assert_array_equal(cnt, cnt_c)
    np.testing.assert_array_equal(lo, lo_c)
    assert (cnt > 0).sum() > 100


def _word_text(n, seed):
    """n bytes of printable words (bytes 33-126) and spaces, 96 distinct
    bytes with the space: a raw-kind row whose suffixes stay tied for
    several rounds."""
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(33, 127, size=int(l), dtype=np.uint8))
             for l in rng.integers(2, 8, size=300)]
    return b' '.join(words[i] for i in rng.integers(0, 300, size=n // 4))[:n]


def _nul_row(case, n):
    """B10 rows holding NUL: UTF-16LE words (every second byte NUL), random
    bytes whose last 200 are NUL (real 0x00 suffixes beside the pads), and
    NUL only."""
    rng = np.random.default_rng(n)
    if case == 'utf16':
        return np.frombuffer(_word_text(n // 2 + 1, n).decode()
                             .encode('utf-16-le')[:n], np.uint8).copy()
    if case == 'nul_tail':
        data = rng.integers(0, 256, size=n).astype(np.uint8)
        data[-200:] = 0
        return data
    return np.zeros(n, np.uint8)


@pytest.mark.parametrize('case, n, N', [('utf16', 70_001, 1 << 17),
                                        ('utf16', 3_000_000, 1 << 22),
                                        ('nul_tail', 70_000, 1 << 17),
                                        ('all_nul', 3000, 4096)])
def test_rotating_kernels_on_nul_rows(cuda, case, n, N):
    """B10 on rows holding NUL, the digit kind's: the 3-byte init and the
    whole doubler bit for bit against their plain versions, and the SA
    against native SA-IS where the row is not poisoned (a row of NUL only
    is, in both)."""
    data = _nul_row(case, n)
    text = torch.zeros(N, dtype=torch.uint8, device=cuda)
    text[:n] = torch.from_numpy(data)
    init = SA.sa_init3_bytes(text, n)
    plain = SA.sa_init3_bytes_plain(text, n)
    assert all(torch.equal(a, b) for a, b in zip(init, plain))
    sa, poisoned, ties = SA.segmented_rotating_sa(text, n)
    psa, ppoisoned, pties = SA.segmented_rotating_sa_plain(text, n)
    torch.cuda.synchronize()
    assert poisoned == ppoisoned == (case == 'all_nul') and ties == pties
    if not poisoned:
        assert torch.equal(sa, psa)
        assert np.array_equal(sa[N - n:].cpu().numpy(),
                              suffix_array_native(data))


def _init3_row(case, n):
    """A row for B10's init: bytes below 128 (so no key reaches bit 24),
    bytes with 254 and 255 among them (keys past 2^24), one symbol, NUL
    bytes among letters, or any bytes."""
    rng = np.random.default_rng(n)
    if case == 'below128':
        return rng.integers(1, 128, size=n, dtype=np.uint8)
    if case == 'high':
        data = rng.integers(0, 256, size=n, dtype=np.uint8)
        data[::7] = 255
        data[3::11] = 254
        return data
    if case == 'one_symbol':
        return np.full(n, ord('a'), np.uint8)
    if case == 'nul':
        data = rng.integers(97, 123, size=n, dtype=np.uint8)
        data[::5] = 0
        return data
    return rng.integers(0, 256, size=n, dtype=np.uint8)


def _init3_passes(text, n):
    """The one-sweep passes B10's init runs on a row: those whose 8-bit
    digit of the 3-byte key is not one for every slot (the device skips the
    others, so the pairs end in the outputs after an even count, in the
    scratch's keys and gs after an odd one)."""
    key = SA._byte_key(text.cpu(), n, 3)
    return sum(int(torch.unique((key >> (8 * p)) & 255).numel() > 1)
               for p in range(4))


#: (case, n, N, executed passes): 3 passes leave the pairs in the scratch's
#: keys and gs, 0 and 4 in rank and sa; rows of one tile and of many, N off
#: the 4096-pair tile, n = 0, 1 and N.
INIT3_CASES = [('below128', 70_000, 1 << 17, 3),
               ('below128', 3_000_000, 1 << 22, 3),
               ('high', 70_001, 1 << 17, 4),
               ('high', 3_000_000, 1 << 22, 4),
               ('one_symbol', 4096, 4096, 3),
               ('one_symbol', 1, 1, 0),
               ('nul', 70_000, 100_003, 3),
               ('random', 0, 4096, 0),
               ('random', 0, 1, 0),
               ('random', 4096, 4096, 4),
               ('random', 5, 8, 3)]


@pytest.mark.parametrize('case, n, N, passes', INIT3_CASES)
def test_init3_cases_run_their_passes(case, n, N, passes):
    """Each row of the card test below runs the passes it is listed with,
    so the cases leave the sorted pairs in both of the init's buffers (no
    card needed: the count follows from the keys)."""
    text = torch.zeros(N, dtype=torch.uint8)
    text[:n] = torch.from_numpy(_init3_row(case, n))
    assert _init3_passes(text, n) == passes


@pytest.mark.parametrize('case, n, N, passes', INIT3_CASES)
def test_init3_matches_plain_at_every_parity(cuda, case, n, N, passes):
    """B10's init sorts inside its outputs on 32-bit keys: sa, rank and gs
    bit for bit against the plain version, whichever buffers the device's
    skip flags leave the pairs in, with one counted launch."""
    text = torch.zeros(N, dtype=torch.uint8, device=cuda)
    text[:n] = torch.from_numpy(_init3_row(case, n))
    before = kernels.LAUNCHES['sa_init3_bytes']
    got = SA.sa_init3_bytes(text, n)
    want = SA.sa_init3_bytes_plain(text.cpu(), n)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES['sa_init3_bytes'] == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


def test_init3_scratch_budget(cuda):
    """B10's init holds at most 8.5 bytes a slot of scratch beside its three
    int32 outputs: the sizer at 2^29 slots, and the allocator's peak over
    one call at 2^26 above what was allocated before it."""
    assert kernels.library().pss_sa_init_scratch_bytes(1 << 29) <= \
        8.5 * (1 << 29)
    N = 1 << 26
    n = N - 100
    text = torch.zeros(N, dtype=torch.uint8, device=cuda)
    text[:n] = torch.from_numpy(_init3_row('high', n))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = SA.sa_init3_bytes(text, n)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    assert peak <= (12 + 8.5) * N + (1 << 20), peak / N
    assert out[0][N - n:].min().item() == 0  # the real slots hold positions


@pytest.mark.parametrize('kind', ['raw', 'digit'])
def test_big_row_derive_of_raw_and_digit_matches_cpu(cuda, kind,
                                                     monkeypatch):
    """A raw and a digit row past ``SEGMENTED_MAX_N`` (lowered) in a derive
    index on the card: B10, the roll, the kind's limb planes and table,
    then its probe, array for array and bound for bound equal to the CPU
    index's, the SA equal to native SA-IS."""
    monkeypatch.setattr(SA, 'SEGMENTED_MAX_N', 1 << 16)
    body = (_nul_row('utf16', 200_000) if kind == 'digit' else
            np.frombuffer(_word_text(200_000, 5), np.uint8))
    chunks = [Chunk(data=body, suffix_array=suffix_array_numpy(body))]
    before = dict(kernels.LAUNCHES)
    gpu = DeviceIndex(chunks, device=cuda, mode='derive')
    torch.cuda.synchronize()
    assert gpu.kind == kind and gpu.n_pad > SA.SEGMENTED_MAX_N
    assert gpu.sa_poisoned == [False]
    # B10's init on a row of up to 2^28 slots is the 6-byte one (B1b's).
    for name in ('sa_init_bytes', 'sa_window_scan', 'sa_rotating_pass',
                 'sa_roll_front', 'seed_prefix', 'seed_table',
                 'raw_limb_planes' if kind == 'raw' else 'digit_limb_planes'):
        assert kernels.LAUNCHES[name] > before[name], name
    for name in ('sa_tie_scan', 'sa_refine_round', 'sa_full_init_bytes'):
        assert kernels.LAUNCHES[name] == before[name], name
    cpu = DeviceIndex(chunks, device='cpu', mode='derive')
    for name in ('text', 'sa', 'tables', 'limbs'):
        assert torch.equal(getattr(gpu, name).cpu(), getattr(cpu, name)), name
    assert np.array_equal(gpu.sa[0, :body.size].cpu().numpy(),
                          suffix_array_native(body))
    packed, lengths = S.pack_patterns(_patterns([body], 3))
    lo_g, cnt_g = gpu.probe(packed, lengths)
    lo_c, cnt_c = cpu.probe(packed, lengths)
    np.testing.assert_array_equal(cnt_g, cnt_c)
    np.testing.assert_array_equal(lo_g, lo_c)
    assert (cnt_g > 0).sum() > 100
