"""Command line of the port: ``python -m fqzcomp5_tpu_torch.cli``.

The flag surface is the JAX package's (``fqzcomp5_tpu.cli``), plus
``-e cuda``: encode (single or paired input) and decode (single or
paired output) through the port's wave engine on ``torch.device("cuda")``.
Every other command line is handed to ``fqzcomp5_tpu.cli`` as it is.
``-e cuda`` encodes every preset; with no visible CUDA device it fails
with ``ERROR:`` and exit code 1 before any output file is opened.
"""

from __future__ import annotations

import shutil
import struct
import sys
import tempfile

from fqzcomp5_tpu import cli as host_cli


def _strip_cuda(argv: list[str]) -> tuple[list[str], bool]:
    """argv without its `-e cuda` / `-ecuda`, and whether it had one."""
    out: list[str] = []
    cuda = False
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-e" and i + 1 < len(argv) and argv[i + 1] == "cuda":
            cuda = True
            i += 2
            continue
        if a == "-ecuda":
            cuda = True
        else:
            out.append(a)
        i += 1
    return out, cuda


def parse_args(argv: list[str]):
    """(Options, decompress, files) of a command line, `-e cuda` or not."""
    return host_cli.parse_args(_strip_cuda(argv)[0])


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    argv, cuda = _strip_cuda(argv)
    if not cuda:
        return host_cli.main(argv)
    arg, decomp, _ = host_cli.parse_args(argv)
    if arg.check_only or arg.inspect_only:
        return host_cli.main(argv)
    # corrupt archives surface as struct/index errors; report them as
    # the host CLI does, without a traceback
    extra = (struct.error, IndexError, KeyError, MemoryError) \
        if decomp else ()
    try:
        return _main_cuda(argv)
    except (ValueError, OSError, *extra) as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 1


def _main_cuda(argv: list[str]) -> int:
    import torch

    from fqzcomp5_tpu import fastq
    from fqzcomp5_tpu.drivers import (Timings, make_deinterleave_writer,
                                      make_fastq_writer)
    from fqzcomp5_tpu_torch import cuda_driver

    arg, decomp, files = host_cli.parse_args(argv)
    if not torch.cuda.is_available():
        raise ValueError("-e cuda needs a CUDA device, and none is visible")
    device = torch.device("cuda")
    t = Timings()

    def open_out(path):
        return (fastq.GzExactWriter(path) if path.endswith(".gz")
                else open(path, "wb"))

    if decomp:
        in_fp = open(files[0], "rb") if files else sys.stdin.buffer
        try:
            in_fp.seek(0, 1)
        except OSError:
            # the container index sits at an offset patched into the
            # header, so decode needs a seekable input: spool pipes
            sp = tempfile.TemporaryFile()
            shutil.copyfileobj(in_fp, sp)
            sp.seek(0)
            in_fp = sp
        try:
            if len(files) == 3:
                arg.paired_mode = 1
                o1, o2 = open_out(files[1]), open_out(files[2])
                try:
                    cuda_driver.decode_file(
                        in_fp, make_deinterleave_writer(o1, o2, arg), arg,
                        t, device)
                finally:
                    o1.close()
                    o2.close()
            elif len(files) >= 2:
                with open_out(files[1]) as out:
                    cuda_driver.decode_file(
                        in_fp, make_fastq_writer(out, arg), arg, t, device)
            else:
                cuda_driver.decode_file(
                    in_fp, make_fastq_writer(sys.stdout.buffer, arg), arg,
                    t, device)
        finally:
            if in_fp is not sys.stdin.buffer:
                in_fp.close()
    elif len(files) == 3:
        arg.paired_mode = 1
        with open(files[2], "wb") as out:
            cuda_driver.encode_paired(files[0], files[1], out, arg, t,
                                      device)
    else:
        in_name = files[0] if files else None
        if len(files) >= 2:
            with open(files[1], "wb") as out:
                cuda_driver.encode_file(in_name, out, arg, t, device)
        else:
            # the index-offset header patch needs a seekable output, so
            # stdout goes through a temporary file
            with tempfile.TemporaryFile() as out:
                cuda_driver.encode_file(in_name, out, arg, t, device)
                out.seek(0)
                shutil.copyfileobj(out, sys.stdout.buffer)

    if arg.verbose >= 0:
        t.report()
    return 0


if __name__ == "__main__":
    sys.exit(main())
