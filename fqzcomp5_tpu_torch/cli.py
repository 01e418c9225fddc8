"""Command line of the port: ``python -m fqzcomp5_tpu_torch.cli``.

The flag surface of fqzcomp5 (fqzcomp5.c:4697-5302), with the port's two
engines:

- ``-e cuda``, the default: encode (single or paired input) and decode
  (single or paired output) through the port's wave engine on
  ``torch.device("cuda")``.  With no visible CUDA device the command
  fails with ``ERROR:`` and exit code 1 before any output file is opened.
- ``-e host``: the native host engine on the CPU (``drivers``), the one
  way to ask for the CPU.  With ``FQZ5_DEVICE_ADAPTIVE`` set (not "" or
  "0"), its encode sends each block's adaptive sections (SEQ*, FQZ*) to
  ``torch.device("cuda")`` (``blocks.encode_block``), failing like ``-e
  cuda`` without a card; ``FQZ5_DEVICE_ADAPTIVE_VERIFY`` also decodes
  each of their payloads back on the host.  Under ``-e cuda`` the switch
  changes nothing: the wave engine encodes those sections on the card.

``--check`` and ``--inspect`` only walk the container, so they run on
the host whatever ``-e`` says.  ``FQZ5_DEC_V3`` set to any non-empty
value makes the cuda engine decode rANS sections through the
boundary-table kernels (``tables="boundary"``) instead of the s3-LUT
ones.  These switches are read here and nowhere below.  ``--daemon
[SOCK]`` serves this command from a pre-warmed process, ``--daemon-stop
[SOCK]`` stops it, ``--daemon-quiet`` silences the server (``daemon``);
``-e tpu`` is refused with ``ERROR:``.
"""

from __future__ import annotations

import os
import struct
import sys

from fqzcomp5_tpu_torch.constants import Method, bit
from fqzcomp5_tpu_torch.options import Options

# fastq/drivers/inspect_tool and torch are imported inside _main() after
# argument parsing, so --help and usage errors exit at interpreter-start
# cost.

USAGE = """Usage: python -m fqzcomp5_tpu_torch.cli [options] [input.fastq [output.fqz5]]
   or: ... [options]    [input_R1.fastq input_R2.fastq output.fqz5]
   or: ... [options] -d [input.fqz5  [output.fastq]]
   or: ... [options] -d [input.fqz5  [output_R1.fastq output_R2.fastq]]
   or: ... --check      [input.fqz5]
   or: ... --inspect    [input.fqz5]
   or: ... --daemon [--daemon-quiet] [SOCKET] | --daemon-stop [SOCKET]

Options:
    -d            Decompress
    --check       Verify file integrity (CRC checksums) without decompressing
    --inspect     Display comprehensive file information
    -p            Output name on third line (+name instead of +)
    -t INT        Number of threads.  Defaults to 4
    -b SIZE       Specify block size. May use K, M and G suffixes
    -v            Increase verbosity
    -V            Silent mode
    -e ENGINE     Compute engine: cuda (the default; "auto" resolves to
                  it): the wave engine on the CUDA device, or host: the
                  native C++ engine on the CPU.  FQZ5_DEC_V3=1 makes
                  cuda decode through the boundary-table kernels.
                  FQZ5_DEVICE_ADAPTIVE=1 makes host encode the adaptive
                  SEQ/FQZ sections on the CUDA device (byte-identical
                  output)

    -n INT        Name encoding method (0=rANS, 1=tok3, 2=tok3+LZP)
    -N INT        Name encoding strategy.
    -s INT        Sequence encoding method (0=rANS, 1=fqz)
    -S INT        Sequence encoding strategy (context size)
    -B            Update sequence context on both strands
    -q INT        Quality encoding method (0=rANS, 1=fqz)
    -Q INT        Quality encoding strategy (0 to 3)

Compression levels:
    -1            Light compression; 10MB block and rANS only
    -3            100MB block and rANS/TOK3
    -5            100MB block and basic seq / qual FQZ modes (default)
    -7            500MB block and higher level FQZ modes
    -9            Maximum compression, with 1GB blocks
"""

TPU_ENGINE_REFUSED = ("-e tpu is the JAX package's engine (python -m "
                      "fqzcomp5_tpu.cli); this command runs -e cuda or -e "
                      "host")


def parse_size(s: str) -> int:
    mult = 1
    if s and s[-1] in "kK":
        mult, s = 1000, s[:-1]
    elif s and s[-1] in "mM":
        mult, s = 1_000_000, s[:-1]
    elif s and s[-1] in "gG":
        mult, s = 1_000_000_000, s[:-1]
    return int(s, 0) * mult


def parse_args(argv: list[str]) -> tuple[Options, bool, list[str]]:
    """(Options, decompress, files) of a command line.  `-e tpu` raises
    ValueError: that engine is the JAX package's."""
    arg = Options()
    decomp = False
    files: list[str] = []
    i = 0
    args = list(argv)
    # pre-strip --check/--inspect (fqzcomp5.c:4778-4796)
    if "--check" in args:
        arg.check_only = 1
        args.remove("--check")
    if "--inspect" in args:
        arg.inspect_only = 1
        args.remove("--inspect")

    def need_val(flag, cur, args, i):
        if cur:
            return cur, i
        i += 1
        if i >= len(args):
            raise SystemExit(f"option {flag} requires a value")
        return args[i], i

    while i < len(args):
        a = args[i]
        if not a.startswith("-") or a == "-":
            files.append(a)
            i += 1
            continue
        body = a[1:]
        while body:
            c, body = body[0], body[1:]
            if c == "d":
                decomp = True
            elif c == "p":
                arg.plus_name = 1
            elif c == "v":
                arg.verbose += 1
            elif c == "V":
                arg.verbose = -1
            elif c == "B":
                arg.both_strands = 1
            elif c == "h":
                print(USAGE)
                raise SystemExit(0)
            elif c in "13579":
                arg.apply_preset(int(c))
            elif c == "e":
                v, i = need_val("-e", body, args, i)
                body = ""
                if v == "tpu":
                    raise ValueError(TPU_ENGINE_REFUSED)
                if v not in ("auto", "cuda", "host"):
                    raise SystemExit(f"unknown engine '{v}'")
                arg.engine = "host" if v == "host" else "cuda"
            elif c == "t":
                v, i = need_val("-t", body, args, i)
                body = ""
                arg.nthread = max(1, int(v))
            elif c == "b":
                v, i = need_val("-b", body, args, i)
                body = ""
                arg.blk_size = parse_size(v)
                arg.clamp_block_size()
            elif c == "n":
                v, i = need_val("-n", body, args, i)
                body = ""
                arg.nstrat = int(v)
                arg.nauto = 0
            elif c == "N":
                v, i = need_val("-N", body, args, i)
                body = ""
                arg.nlevel = min(19, max(0, int(v)))
            elif c == "s":
                v, i = need_val("-s", body, args, i)
                body = ""
                arg.sstrat = int(v)
                if not arg.sstrat:
                    arg.sauto = 0
            elif c == "S":
                v, i = need_val("-S", body, args, i)
                body = ""
                arg.slevel = min(16, max(0, int(v)))
                arg.sstrat = 1
                arg.scustom = 1
            elif c == "q":
                v, i = need_val("-q", body, args, i)
                body = ""
                arg.qstrat = int(v)
                if arg.qstrat and not arg.qauto:
                    arg.qauto = bit(Method.FQZ0)
                elif not arg.qstrat:
                    arg.qauto = 0
            elif c == "Q":
                v, i = need_val("-Q", body, args, i)
                body = ""
                arg.qlevel = int(v)
                arg.qstrat = 1
                arg.qauto = 1 << (int(Method.FQZ0) + arg.qlevel)
            elif c == "-":
                # long option not recognised
                raise SystemExit(f"unknown option {a}")
            else:
                print(USAGE, file=sys.stderr)
                raise SystemExit(1)
        i += 1
    return arg, decomp, files


def main(argv=None) -> int:
    """CLI entry; decode/encode failures print ERROR: and exit 1
    (reference behavior, fqzcomp5.c decode drivers)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    # the daemon verbs take no codec flags: handled before parsing
    if "--daemon" in argv or "--daemon-stop" in argv:
        from fqzcomp5_tpu_torch import daemon

        rest = [a for a in argv
                if a not in ("--daemon", "--daemon-stop", "--daemon-quiet")]
        sock = rest[0] if rest else None
        if "--daemon-stop" in argv:
            if daemon.stop(sock):
                return 0
            print("fqz5 daemon: no daemon to stop", file=sys.stderr)
            return 1
        idle = os.environ.get("FQZ5_DAEMON_IDLE")
        return daemon.serve(sock, quiet="--daemon-quiet" in argv,
                            idle_timeout=float(idle) if idle else None)
    try:
        probe, decomp, _ = parse_args(argv)
        reading_archive = bool(decomp or probe.check_only
                               or probe.inspect_only)
    except SystemExit:
        raise
    except Exception:
        reading_archive = False
    # corrupt/truncated archives surface as struct.error or
    # Index/Key/MemoryError from bad offsets and sizes; the reference
    # prints ERROR: and exits 1, never a traceback.  Encode-side runs
    # keep the narrow catch so real bugs still show a traceback.
    extra = ((struct.error, IndexError, KeyError, MemoryError)
             if reading_archive else ())
    try:
        return _main(argv)
    except (ValueError, OSError, *extra) as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 1


def switch_on(name: str) -> bool:
    """Whether the environment sets the switch name (not "" or "0")."""
    return os.environ.get(name, "0") not in ("", "0")


def _cuda_device(what: str):
    import torch

    if not torch.cuda.is_available():
        raise ValueError(f"{what} needs a CUDA device, and none is visible")
    return torch.device("cuda")


def _engine(arg: Options, t, decomp: bool):
    """(encode, encode_paired, decode) of the engine arg names, each
    bound to arg and the timings t.  A card the run needs and does not
    see raises ValueError here, before any output file is opened."""
    if arg.engine == "host":
        from fqzcomp5_tpu_torch import drivers

        dev = None
        if switch_on("FQZ5_DEVICE_ADAPTIVE") and not decomp:
            dev = _cuda_device("-e host with FQZ5_DEVICE_ADAPTIVE")
            arg.verify_device = int(switch_on("FQZ5_DEVICE_ADAPTIVE_VERIFY"))
        return (lambda i, o: drivers.encode_file(i, o, arg, t, dev),
                lambda i1, i2, o: drivers.encode_paired(i1, i2, o, arg, t,
                                                        dev),
                lambda i, w: drivers.decode_file(i, w, arg, t))
    from fqzcomp5_tpu_torch import cuda_driver

    dev = _cuda_device("-e cuda")
    tables = "boundary" if os.environ.get("FQZ5_DEC_V3") else "lut"
    return (lambda i, o: cuda_driver.encode_file(i, o, arg, t, dev),
            lambda i1, i2, o: cuda_driver.encode_paired(i1, i2, o, arg, t,
                                                        dev),
            lambda i, w: cuda_driver.decode_file(i, w, arg, t, dev,
                                                 tables=tables))


def _main(argv) -> int:
    arg, decomp, files = parse_args(argv)

    from fqzcomp5_tpu_torch import fastq, inspect_tool
    from fqzcomp5_tpu_torch.drivers import (Timings,
                                            make_deinterleave_writer,
                                            make_fastq_writer)

    if arg.check_only or arg.inspect_only:
        if len(files) != 1:
            print("Error: --check/--inspect require exactly one input file",
                  file=sys.stderr)
            return 1
        with open(files[0], "rb") as fp:
            if arg.check_only:
                return 0 if inspect_tool.check_integrity(fp, arg) == 0 else 1
            return 0 if inspect_tool.inspect_file(fp, arg) == 0 else 1

    if not files and sys.stdin.isatty():
        print(USAGE)
        return 0

    t = Timings()
    # the engine is settled (and a missing card reported) before any
    # output file is opened
    encode, encode_paired, decode = _engine(arg, t, decomp)
    is_gz = lambda p: p is not None and p.endswith(".gz")  # noqa: E731

    if decomp:
        in_name = files[0] if len(files) >= 1 else None
        in_fp = open(in_name, "rb") if in_name else sys.stdin.buffer
        # the container index lives at an offset patched into the
        # header, so decode needs a seekable input; spool true pipes
        # to an unlinked temp file
        try:
            in_fp.seek(0, 1)
        except OSError:
            import tempfile

            sp = tempfile.TemporaryFile()
            while True:
                chunk = in_fp.read(16 << 20)
                if not chunk:
                    break
                sp.write(chunk)
            sp.seek(0)
            in_fp = sp
        if len(files) == 3:
            arg.paired_mode = 1
            o1 = fastq.GzExactWriter(files[1]) if is_gz(files[1]) \
                else open(files[1], "wb")
            o2 = fastq.GzExactWriter(files[2]) if is_gz(files[2]) \
                else open(files[2], "wb")
            try:
                decode(in_fp, make_deinterleave_writer(o1, o2, arg))
            finally:
                o1.close()
                o2.close()
        else:
            out_name = files[1] if len(files) >= 2 else None
            if out_name:
                out = fastq.GzExactWriter(out_name) \
                    if is_gz(out_name) else open(out_name, "wb")
            else:
                out = sys.stdout.buffer
            try:
                decode(in_fp, make_fastq_writer(out, arg))
            finally:
                if out_name:
                    out.close()
        if in_name:
            in_fp.close()
    elif len(files) == 3:
        arg.paired_mode = 1
        with open(files[2], "wb") as out:
            encode_paired(files[0], files[1], out)
    else:
        in_name = files[0] if len(files) >= 1 else None
        out_name = files[1] if len(files) >= 2 else None
        if out_name:
            with open(out_name, "wb") as out:
                encode(in_name, out)
        else:
            # stdout pipes aren't seekable; the index-offset header
            # patch needs a seek, so spool via a temp file
            import shutil
            import tempfile
            with tempfile.TemporaryFile() as out:
                encode(in_name, out)
                out.seek(0)
                shutil.copyfileobj(out, sys.stdout.buffer)

    if arg.verbose >= 0:
        t.report()
    return 0


if __name__ == "__main__":
    sys.exit(main())
