#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (fqzcomp5_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each printed with its time; any failure exits non-zero:
  1. device  -- requires torch.cuda; prints the card's name and power
     limit as nvidia-smi reports them.
  2. build   -- builds the native host library and the CUDA kernels
     from the checkout's sources (nvcc, sm_90a).
  3. kernels -- runs each of the three kernels and its plain PyTorch
     version on the same inputs at main-path shapes (64 streams, 4096
     steps, order-0 and order-1 at shift 10 and 12, ragged lengths, a
     single-symbol stream) and requires bit-identical results (the
     tolerance is zero: this is integer entropy coding); times both on
     the card with CUDA events.
  4. e2e     -- makes a FASTQ corpus with seeded numpy (150 bp reads,
     random-walk qualities) and drives the port's CLI
     (fqzcomp5_tpu_torch.cli -e cuda) at -1 and -3: encode, decode,
     cmp; decodes the same archives with the host engine's CLI; counts
     the kernel launches of that run; and encodes a 4 MB prefix both on
     the card and on the CPU (plain versions), requiring equal archives.
The last two lines are a JSON object of per-kernel results and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import filecmp
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CORPUS_MB = 256
PREFIX_MB = 4
SEED = 42
B_STREAMS = 64
T_STEPS = 4096


def log(msg: str) -> None:
    print(msg, flush=True)


def phase(name: str, t0: float) -> None:
    log(f"[phase] {name}: {time.monotonic() - t0:.3f} s")


# ---------------------------------------------------------------------
# phase 3 inputs: synthetic streams and their coder tables

def _streams(rng, np):
    """64 byte streams of ragged lengths (at most T_STEPS*32 bytes):
    DNA-like, random-walk qualities, uniform bytes, and one
    single-symbol stream."""
    out = []
    cap = T_STEPS * 32
    for b in range(B_STREAMS):
        n = cap if b == 0 else int(rng.integers(cap // 2, cap + 1))
        kind = b % 3
        if b == 5:
            d = np.full(n, 67, np.uint8)
        elif kind == 0:
            d = rng.choice(np.frombuffer(b"ACGTN", np.uint8), n,
                           p=[0.3, 0.2, 0.2, 0.29, 0.01])
        elif kind == 1:
            steps = rng.integers(-2, 3, n)
            d = (np.cumsum(steps) % 40 + 36).astype(np.uint8)
        else:
            d = rng.integers(0, 256, n).astype(np.uint8)
        out.append(d.astype(np.uint8))
    return out


def _normalise(counts, shift, np):
    """Rows of counts -> rows summing to 1<<shift, every counted symbol
    at least 1 (rows of zeros stay zero)."""
    tot = 1 << shift
    c = counts.astype(np.int64)
    rs = c.sum(-1, keepdims=True)
    k = (c > 0).sum(-1, keepdims=True)
    f = np.where(c > 0, 1 + (c * (tot - k)) // np.maximum(rs, 1), 0)
    fix = np.where(rs[..., 0] > 0, tot - f.sum(-1), 0)
    am = f.argmax(-1)
    np.put_along_axis(f, am[..., None],
                      np.take_along_axis(f, am[..., None], -1)
                      + fix[..., None], -1)
    return f


def _time(fn, reps: int):
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    z = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        out = fn()
    z.record()
    torch.cuda.synchronize()
    return a.elapsed_time(z) / reps, out


def _max_err(xs, ys) -> int:
    import torch

    err = 0
    for x, y in zip(xs, ys):
        if x.shape != y.shape:
            raise AssertionError(f"shape {tuple(x.shape)} != {tuple(y.shape)}")
        if x.numel():
            d = (x.to(torch.int64) - y.to(torch.int64)).abs().max()
            err = max(err, int(d))
    return err


def kernels_vs_plain(np, torch, dev):
    from fqzcomp5_tpu_torch import engine_cuda
    from fqzcomp5_tpu_torch.ops import rans_cuda, rans_cuda_dec, rans_torch

    rng = np.random.default_rng(SEED)
    datas = _streams(rng, np)
    lens = np.array([len(d) for d in datas], np.int32)
    B, T = B_STREAMS, T_STEPS
    res = {"encode_walk": [], "decode_o0": [], "decode_o1": []}

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def compact(Rf, words, nw):
        Rf = Rf.cpu().numpy().view(np.uint32)
        w = words.cpu().numpy().view(np.uint16)
        nw = nw.cpu().numpy()
        rows = [w[b, w.shape[1] - nw[b]:] for b in range(B)]
        Wmax = max(1, max(len(r) for r in rows))
        wr = np.zeros((B, Wmax), np.uint16)
        for b, r in enumerate(rows):
            wr[b, :len(r)] = r
        return Rf, wr

    def record(name, label, err, k_ms, p_ms, nsym, note=""):
        res[name].append((label, err, k_ms, p_ms))
        log(f"  {name} {label}: max_abs_err {err}  kernel {k_ms:.3f} ms "
            f"({nsym / k_ms / 1e6:.3f} GB/s of symbols)  plain {p_ms:.3f} ms"
            + note)

    def check_enc(label, args, kw, nsym):
        k_ms, k_out = _time(lambda: rans_cuda.encode_walk(*args, **kw), 5)
        p_ms, p_out = _time(
            lambda: rans_torch.encode_walk_ref(*args, **kw), 1)
        nk, npl = k_out[2], p_out[2]
        err = _max_err([k_out[0], nk], [p_out[0], npl])
        cap = T * 32
        for b in range(B):
            n = int(nk[b])
            err = max(err, _max_err([k_out[1][b, cap - n:]],
                                    [p_out[1][b, cap - n:]]))
        record("encode_walk", label, err, k_ms, p_ms, nsym)
        return k_out

    # order-0: uint8 plane + symbol counts, native prep tables
    plane = np.zeros((B, T * 32), np.uint8)
    freqs0 = np.empty((B, 256), np.uint32)
    for b, d in enumerate(datas):
        plane[b, :len(d)] = d
        freqs0[b] = engine_cuda.o0_prep(d.tobytes())[1]
    tab0 = rans_torch.tables_from_numpy(freqs0, "freqs", shift=12,
                                        device=dev)
    enc0 = check_enc("o0 shift12", (put(plane.reshape(B, T, 32)), tab0, 12),
                     {"nsym": put(lens)}, int(lens.sum()))
    Rf0, w0 = compact(*enc0)
    s3_0 = rans_torch.tables_from_numpy(rans_torch.build_s3(freqs0, 12),
                                        "s3", device=dev)
    args = (put(w0.view(np.int16)), put(Rf0.view(np.int32)), s3_0,
            put(lens // 32), T)
    k_ms, k_out = _time(lambda: rans_cuda_dec.decode_o0(*args), 5)
    p_ms, p_out = _time(lambda: rans_torch.decode_o0_ref(*args), 1)
    err = _max_err(k_out, p_out)
    syms = k_out[0].cpu().numpy()
    for b, d in enumerate(datas):
        t = len(d) // 32
        if not np.array_equal(syms[b, :t].reshape(-1), d[:t * 32]):
            raise AssertionError(f"decode_o0: stream {b} does not round-trip")
    record("decode_o0", "shift12", err, k_ms, p_ms,
           int((lens // 32).sum()) * 32, "  (round-trips the sources)")

    # order-1: flat ctx*256+sym plane, per-chunk layout, lane 31 seeded
    iszs = lens // 32
    flat = np.full((B, T, 32), 256 * 256, np.int32)
    counts = np.zeros((B, 256 * 256), np.int64)
    for b, d in enumerate(datas):
        isz = int(iszs[b])
        ch = d[:32 * isz].reshape(32, isz).T.astype(np.int32)
        f = np.empty((isz, 32), np.int32)
        f[0] = ch[0]
        f[1:] = ch[:-1] * 256 + ch[1:]
        flat[b, :isz] = f
        counts[b] = np.bincount(f.reshape(-1), minlength=256 * 256)
    R0 = np.full((B, 32), rans_torch.RANS_L, np.uint32)
    R0[:, 31] = rng.integers(1 << 15, 1 << 31, B)
    for shift in (10, 12):
        fr = _normalise(counts.reshape(B, 256, 256), shift, np)
        tab1 = rans_torch.tables_from_numpy(fr, "freqs", shift=shift,
                                            device=dev)
        enc1 = check_enc(f"o1 shift{shift}", (put(flat), tab1, shift),
                         {"R0": put(R0.view(np.int32))},
                         int(iszs.sum()) * 32)
        Rf1, w1 = compact(*enc1)
        s3_1 = rans_torch.tables_from_numpy(
            rans_torch.build_s3(fr, shift).reshape(B, -1), "s3",
            device=dev)
        args = (put(w1.view(np.int16)), put(Rf1.view(np.int32)), s3_1,
                put(iszs.astype(np.int32)), T, shift)
        k_ms, k_out = _time(lambda: rans_cuda_dec.decode_o1(*args), 5)
        p_ms, p_out = _time(lambda: rans_torch.decode_o1_ref(*args), 1)
        err = _max_err(k_out, p_out)
        syms = k_out[0].cpu().numpy()
        for b, d in enumerate(datas):
            isz = int(iszs[b])
            if not np.array_equal(syms[b, :isz].T.reshape(-1),
                                  d[:32 * isz]):
                raise AssertionError(
                    f"decode_o1 shift{shift}: stream {b} does not "
                    "round-trip")
        record("decode_o1", f"shift{shift}", err, k_ms, p_ms,
               int(iszs.sum()) * 32, "  (round-trips the sources)")
    for name, rows in res.items():
        bad = [r for r in rows if r[1] != 0]
        if bad:
            raise AssertionError(f"{name} disagrees with its plain version: "
                                 f"{bad}")
    return res


# ---------------------------------------------------------------------
# phase 4: corpus and the CLI runs

def make_corpus(path: str, target_mb: int, np) -> int:
    """FASTQ of 150 bp reads sampled from a random 1 Mbp reference, with
    random-walk qualities (bench.gen_corpus's model at fixed length)."""
    rng = np.random.default_rng(SEED)
    chrom = rng.choice(np.frombuffer(b"ACGT", np.uint8), 1 << 20)
    L = 150
    total = i = 0
    with open(path, "wb") as out:
        while total < target_mb * 1_000_000:
            n = 20000
            off = rng.integers(0, len(chrom) - L, n)
            seq = chrom[off[:, None] + np.arange(L)[None, :]]
            steps = rng.integers(-2, 3, (n, L))
            q = (np.clip(np.cumsum(steps, axis=1) % 40 + 3, 0, 45)
                 + 33).astype(np.uint8)
            blob = b"".join(
                b"@SRR123.%d %d length=150\n" % (i + k, i + k)
                + seq[k].tobytes() + b"\n+\n" + q[k].tobytes() + b"\n"
                for k in range(n))
            i += n
            out.write(blob)
            total += len(blob)
    return total


def prefix_copy(src: str, dst: str, nbytes: int) -> None:
    """Whole records of src up to about nbytes."""
    with open(src, "rb") as fp:
        head = fp.read(nbytes)
    lines = head.split(b"\n")
    keep = (len(lines) - 1) // 4 * 4
    with open(dst, "wb") as fp:
        fp.write(b"\n".join(lines[:keep]) + b"\n")


def run_cli(argv) -> None:
    from fqzcomp5_tpu_torch import cli

    rc = cli.main(argv)
    if rc != 0:
        raise RuntimeError(f"cli {' '.join(argv)} exited {rc}")


def same(a: str, b: str) -> None:
    if not filecmp.cmp(a, b, shallow=False):
        raise AssertionError(f"{a} and {b} differ")


def main() -> int:
    t0 = time.monotonic()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        log("ERROR: no CUDA device is visible")
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind} (torch {torch.__version__}, cuda "
        f"{torch.version.cuda})")
    log(smi)
    phase("device", t0)

    t0 = time.monotonic()
    sys.path.insert(0, ROOT)
    from fqzcomp5_tpu_torch import cli, cuda_driver, engine_cuda
    from fqzcomp5_tpu_torch.ops import _build, rans_cuda, rans_cuda_dec

    t1 = time.monotonic()
    engine_cuda._lib()  # builds the native host library (make) if absent
    log(f"native host library: {time.monotonic() - t1:.3f} s")
    _build.lib()
    log(f"CUDA kernels: nvcc {_build.build_seconds:.3f} s -> "
        f"{os.path.relpath(_build.lib_path(), ROOT)}")
    with open(os.path.join(_build.BUILD_DIR, "build.log")) as fp:
        for line in fp:
            if "registers" in line or "spill" in line:
                log("  ptxas: " + line.strip())
    phase("build", t0)

    t0 = time.monotonic()
    kres = kernels_vs_plain(np, torch, torch.device("cuda"))
    phase("kernels", t0)

    t0 = time.monotonic()
    work = tempfile.mkdtemp(prefix="fqz5_chip_smoke_")
    try:
        src = os.path.join(work, "in.fastq")
        nbytes = make_corpus(src, CORPUS_MB, np)
        log(f"corpus: {nbytes} bytes, 150 bp reads ("
            f"{time.monotonic() - t0:.3f} s)")
        counted = (rans_cuda.encode_walk, rans_cuda_dec.decode_o0,
                   rans_cuda_dec.decode_o1)
        for fn in counted:
            fn.launches = 0
        engine_cuda.decode_o1_batch.calls = 0
        engine_cuda.decode_o1_batch.s3_bytes = 0
        rates = {}
        for lvl in ("-1", "-3"):
            comp = os.path.join(work, f"c{lvl}.fqz5")
            out = os.path.join(work, f"o{lvl}.fastq")
            t1 = time.monotonic()
            run_cli(["-e", "cuda", lvl, "-V", src, comp])
            enc_s = time.monotonic() - t1
            t1 = time.monotonic()
            run_cli(["-e", "cuda", "-d", "-V", comp, out])
            dec_s = time.monotonic() - t1
            same(src, out)
            os.remove(out)
            t1 = time.monotonic()
            # without -e cuda the port's CLI hands the command to the
            # host engine
            subprocess.run([sys.executable, "-m", "fqzcomp5_tpu_torch.cli",
                            "-d", "-V", comp, out], cwd=ROOT, check=True)
            host_s = time.monotonic() - t1
            same(src, out)
            os.remove(out)
            csize = os.path.getsize(comp)
            rates[lvl] = (nbytes / enc_s / 1e6, nbytes / dec_s / 1e6)
            log(f"e2e {lvl}: {nbytes} -> {csize} bytes; encode {enc_s:.3f} s"
                f" = {rates[lvl][0]:.2f} MB/s, decode {dec_s:.3f} s = "
                f"{rates[lvl][1]:.2f} MB/s; host-engine decode "
                f"{host_s:.3f} s; both decodes match the source")
        launches = {fn.__name__: fn.launches for fn in counted}
        log(f"kernel launches in the e2e run: {launches}")
        calls = engine_cuda.decode_o1_batch.calls
        log(f"order-1 decode s3 upload: {engine_cuda.decode_o1_batch.s3_bytes}"
            f" bytes over {calls} waves")
        zero = [k for k, v in launches.items() if v == 0]
        if zero:
            raise AssertionError(f"kernels never launched on the main path: "
                                 f"{zero}")

        pre = os.path.join(work, "prefix.fastq")
        prefix_copy(src, pre, PREFIX_MB * 1_000_000)
        gpu_c = os.path.join(work, "prefix.gpu.fqz5")
        cpu_c = os.path.join(work, "prefix.cpu.fqz5")
        run_cli(["-e", "cuda", "-1", "-V", pre, gpu_c])
        arg, _, _ = cli.parse_args(["-1", "-V"])
        t1 = time.monotonic()
        with open(cpu_c, "wb") as fp:
            cuda_driver.encode_file(pre, fp, arg, cuda_driver.Timings(),
                                    torch.device("cpu"))
        same(gpu_c, cpu_c)
        log(f"4 MB prefix: card and CPU (plain versions) archives are equal"
            f" (CPU encode {time.monotonic() - t1:.3f} s)")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    phase("e2e", t0)

    src_of = {"encode_walk": "fqzcomp5_tpu_torch/csrc/rans_encode.cu",
              "decode_o0": "fqzcomp5_tpu_torch/csrc/rans_decode.cu",
              "decode_o1": "fqzcomp5_tpu_torch/csrc/rans_decode.cu"}
    replaces = {"encode_walk": "fqzcomp5_tpu/ops/rans_pallas.py:140",
                "decode_o0": "fqzcomp5_tpu/ops/rans_pallas_dec.py:1226",
                "decode_o1": "fqzcomp5_tpu/ops/rans_pallas_dec.py:1396"}
    kernels = []
    for name, rows in kres.items():
        kernels.append({
            "name": name, "route": "cuda", "source": src_of[name],
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": max(r[1] for r in rows),
            "ms": sum(r[2] for r in rows) / len(rows),
            "plain_ms": sum(r[3] for r in rows) / len(rows)})
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
