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
from pysubstringsearch_tpu_torch.container import Chunk, read_container
from pysubstringsearch_tpu_torch.models.index import DeviceIndex
from pysubstringsearch_tpu_torch.ops import kernels
from pysubstringsearch_tpu_torch.ops import search as S
from pysubstringsearch_tpu_torch.ops import suffix_array as SA
from pysubstringsearch_tpu_torch.ops.native import suffix_array_native
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
    limbs = S.ranked_limb_planes(packed, sa, n, depth, bits, K)
    table = S.seed_table(packed, sa, n, base, depth, bits)
    torch.cuda.synchronize()
    for name in ('ranked_pack', 'ranked_limb_planes', 'seed_table'):
        assert kernels.LAUNCHES[name] == before[name] + 1
    ref = S.ranked_pack_plain(text, n, rk, bits)
    assert torch.equal(packed, ref)
    assert torch.equal(limbs, S.ranked_limb_planes_plain(ref, sa, n, depth,
                                                         bits, K))
    assert torch.equal(table, S.seed_table_plain(ref, sa, n, base, depth,
                                                 bits))
    host = S.pad_limbs_host(S.build_ranked_limbs_host(
        body, sa[:n].cpu().numpy(), rank, K, depth, bits), N)
    assert np.array_equal(limbs.cpu().numpy(), host)


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


def test_reader_on_card_matches_cpu_reader(cuda, tmp_path):
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
    before = kernels.LAUNCHES['gather_hits_flat']
    assert collections.Counter(gpu.search_multiple(pats)) == \
        collections.Counter(cpu.search_multiple(pats))
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


@pytest.mark.parametrize('n', [1, 2049, (1 << 22) + 5])
def test_scans_match_cumsum_and_cummax(cuda, n):
    g = torch.Generator(device='cpu').manual_seed(n)
    x = torch.randint(-50, 1000, (n,), generator=g,
                      dtype=torch.int32).to(cuda)
    ex = SA.scan_exclusive_sum(x)
    assert ex.shape == (n + 1,) and int(ex[0]) == 0
    assert torch.equal(ex[1:], torch.cumsum(x, 0).to(torch.int32))
    assert torch.equal(SA.scan_inclusive_max(x),
                       torch.cummax(x, 0).values)


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
    limbs = S.raw_limb_planes(packed, sa, n, 3, 3)
    assert torch.equal(limbs, S.raw_limb_planes_plain(packed, sa, n, 3, 3))
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
    """B12d: the bucket table (K7 at base 258, K3) and the limb planes (K7
    at depth 3, the limb-plane kernel at offset 2, stride 3), bit for bit
    against their plain versions and the host builders."""
    data = _digit_body(size, size)
    n = data.size
    N = _pad_len(n + S.PAD_MARGIN)
    text = torch.zeros(N, dtype=torch.uint8, device=cuda)
    text[:n] = torch.from_numpy(data)
    sa = SA.derive_sa(text, n)[0]
    before = dict(kernels.LAUNCHES)
    scratch = torch.empty(N, dtype=torch.int32, device=cuda)
    table = S.digit_bucket_table(text, sa, n, depth, scratch=scratch)
    limbs = S.digit_limb_planes(text, sa, n, 5, scratch=scratch)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES['seed_prefix'] == before['seed_prefix'] + 2
    assert kernels.LAUNCHES['seed_table'] == before['seed_table'] + 1
    assert kernels.LAUNCHES['digit_limb_planes'] == \
        before['digit_limb_planes'] + 1
    assert torch.equal(table, S.digit_bucket_table_plain(text, sa, n, depth))
    assert torch.equal(limbs, S.digit_limb_planes_plain(text, sa, n, 5))
    if depth == 3:
        # The index's route: the table's K7 values feed the limbs, so K7
        # runs once for both.
        before = dict(kernels.LAUNCHES)
        pv = torch.empty(N, dtype=torch.int32, device=cuda)
        S.digit_bucket_table(text, sa, n, 3, scratch=pv)
        again = S.digit_limb_planes(text, sa, n, 5, prefix=pv)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES['seed_prefix'] == before['seed_prefix'] + 1
        assert torch.equal(again, limbs)
    sa_h = sa[:n].cpu().numpy()
    assert np.array_equal(table.cpu().numpy(),
                          S.build_bucket_table_host(data, sa_h, depth))
    assert np.array_equal(limbs.cpu().numpy(), S.pad_limbs_host(
        S.build_limbs_host(data, sa_h, 5), N))


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
    # K7 once a row at depth 3 (table and limbs share it), twice at 2.
    assert kernels.LAUNCHES['seed_prefix'] - k7 == \
        gpu.num_chunks * (1 if deep_min else 2)
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
    assert torch.equal(SA.sa_full_doubling_int(ranks),
                       SA.sa_full_doubling_int_plain(ranks))
    assert np.array_equal(SA.suffix_array_int(vals, 1 << 20, 'torch'),
                          SA.suffix_array_int(vals, 1 << 20, 'native'))
    torch.cuda.synchronize()
    for name in ('sa_full_init_bytes', 'sa_full_round'):
        assert kernels.LAUNCHES[name] > before[name], name


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


@pytest.mark.parametrize('size', [1, 70_000, 3_000_000])
def test_probe_bytes_matches_plain(cuda, size):
    """B15 over [C, N] rows (an empty one among them) equals its plain
    version for every (row, pattern), lower bounds included, in one launch;
    probe_bounds is its C = 1 case."""
    bodies = [_body('nul', size, 11), _body('raw', max(size // 3, 1), 12),
              np.zeros(0, np.uint8)]
    N = _pad_len(max(b.size for b in bodies) + S.PAD_MARGIN)
    text = torch.zeros((3, N), dtype=torch.uint8, device=cuda)
    sa = torch.zeros((3, N), dtype=torch.int32, device=cuda)
    for i, b in enumerate(bodies):
        text[i, : b.size] = torch.from_numpy(b)
        sa[i, : b.size] = torch.from_numpy(suffix_array_native(b))
    n = torch.tensor([b.size for b in bodies], dtype=torch.int32,
                     device=cuda)
    pats = _patterns(bodies[:1], 3) if size > 100 else [b'', b'\n', b'a']
    pats.append(bodies[0].tobytes()[:300] + b'x')  # longer than a row
    packed, lengths = S.pack_patterns(pats)
    p, l = torch.from_numpy(packed).to(cuda), torch.from_numpy(lengths).to(cuda)
    before = kernels.LAUNCHES['probe_bytes']
    lo, cnt = S.probe_bytes(text, n, sa, p, l)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES['probe_bytes'] == before + 1
    lo_p, cnt_p = S.probe_bytes_plain(text, n, sa, p, l)
    assert torch.equal(lo, lo_p) and torch.equal(cnt, cnt_p)
    assert int(cnt[0, 0]) == bodies[0].size and int(cnt[2].abs().sum()) == 0
    lo1, cnt1 = S.probe_bounds(text[0], bodies[0].size, sa[0], p, l)
    assert torch.equal(lo1, lo[0]) and torch.equal(cnt1, cnt[0])


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
