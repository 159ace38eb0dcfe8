"""Command-line entry points: build an index from a line file, query it,
or shard it, as ``python -m pysubstringsearch_tpu`` does.

    python -m pysubstringsearch_tpu_torch build  corpus.txt corpus.idx [--chunk-mb N]
    python -m pysubstringsearch_tpu_torch search corpus.idx PATTERN [PATTERN ...]
    python -m pysubstringsearch_tpu_torch shard  corpus.idx out_dir --shards N

``search`` opens its Reader on the CUDA card, or with ``--device cpu`` on
the CPU (the kernels' plain PyTorch versions).
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog='pysubstringsearch_tpu_torch')
    sub = parser.add_subparsers(dest='cmd', required=True)

    b = sub.add_parser('build', help='build an index from a file of lines')
    b.add_argument('corpus')
    b.add_argument('index')
    b.add_argument('--chunk-mb', type=int, default=512)
    b.add_argument('--sa-backend', default='auto',
                   choices=['auto', 'torch', 'native', 'numpy'])
    b.add_argument('--profile', action='store_true')

    s = sub.add_parser('search', help='search an index')
    s.add_argument('index')
    s.add_argument('patterns', nargs='+')
    s.add_argument('--count-only', action='store_true')
    s.add_argument('--device', default='cuda',
                   help="where the index lives: 'cuda' (default) or 'cpu'")
    s.add_argument('--profile', action='store_true')

    h = sub.add_parser('shard', help='split an index into a sharded manifest')
    h.add_argument('index')
    h.add_argument('out_dir')
    h.add_argument('--shards', type=int, required=True)

    args = parser.parse_args(argv)

    from . import Reader, Writer

    if args.cmd == 'build':
        writer = Writer(
            args.index,
            max_chunk_len=args.chunk_mb * 1024 * 1024,
            sa_backend=args.sa_backend,
        )
        writer.add_entries_from_file_lines(args.corpus)
        writer.close()
        if args.profile:
            print(writer.profiler.report(), file=sys.stderr)
        return 0

    if args.cmd == 'search':
        reader = Reader(args.index, device=args.device)
        # The device index builds on a background thread: wait for it, so
        # the patterns are answered on the device and the process exits
        # with no build in flight.
        reader.wait_device_ready()
        for pattern in args.patterns:
            results = reader.search(pattern)
            if args.count_only:
                print(f'{pattern}\t{len(results)}')
            else:
                for line in results:
                    print(line)
        if args.profile:
            print(reader.profiler.report(), file=sys.stderr)
        return 0

    if args.cmd == 'shard':
        from .parallel import manifest

        manifest.convert_index(args.index, args.out_dir, args.shards)
        return 0

    return 2


if __name__ == '__main__':
    sys.exit(main())
