"""Command line of the port: ``python -m huffman_codec_tpu_torch``.

The same flags, stderr lines and exit codes 1-15 as the JAX package's
command line (``python -m huffman_codec_tpu``), which keeps those of the
reference binary, and its defaults but one (v1's ``--backend``, below):

- ``-c`` is the default; a later ``-c``/``-d`` overrides an earlier one
- decompression ignores ``-m``/``-a``/``-w`` (the header holds them)
- the output defaults to ``b.out``; "writing N bytes to <path>" goes to
  stderr, before the write
- exit codes 1-15 as in the reference's table

Extensions behind long options:

- ``--format {v1,v2,v3}``: v1 is the reference's wire format (default), v2
  the host-parallel chunked FGK container, v3 the device container of
  ``TorchCodec``
- ``--backend {native,torch,pyref}``: how v1 runs. ``torch`` (default) is
  the device ``V1Codec``; ``native`` the host C++ runtime (the JAX command
  line's default); ``pyref`` the pure-Python model. The two host models
  run only when asked for.

``--format v3`` and the v1 default ``--backend torch`` run on the CUDA
device and never anywhere else: without a GPU they exit with "no CUDA
device". Only ``--backend native`` falls back, to ``pyref``, when g++
cannot build the host runtime, as the JAX command line does: both are
host models that write the same bytes, so the fallback hides no device
and no kernel.
``main(argv, device="cpu")`` runs the device paths on the plain PyTorch
versions instead (for tests); the shell's entry point has no such flag.
"""

from __future__ import annotations

import getopt
import sys
import time

from huffman_codec_tpu_torch.formats import V3_MAGIC
from huffman_codec_tpu_torch.models import CodecConfig, TorchCodec, V1Codec
from huffman_codec_tpu_torch.native import runtime
from huffman_codec_tpu_torch.pyref import codec as pyref
from huffman_codec_tpu_torch.utils.dump import dump_v1_tree, dump_v3_tables
from huffman_codec_tpu_torch.utils.metrics import CodecMetrics

HELP_MESSAGE = """USAGE:
  huffman-codec-tpu [-cm] -i IFILE [-o OFILE]
  huffman-codec-tpu [-cm] -a [-w WIDTH] -i IFILE [-o OFILE]
  huffman-codec-tpu -d -i IFILE [-o OFILE] | -h

OPTION:
  -c/-d  perform compression/decompression
  -m     use differential model for preprocessing
  -a     use adaptive block RLE (default: RLE)
  -w     width of 2D data (default: 512)
  -i     input file path
  -o     output file path (default: b.out)
  -h     show this help

FRAMEWORK OPTIONS:
  --backend {native,torch,pyref} v1 execution backend (default: torch);
                                 torch runs on the CUDA device
  --format {v1,v2,v3}            container format (default: v1); v3 runs
                                 on the CUDA device
  --chunk-size N                 chunk bytes for v2/v3 (default: 65536)
  --threads N                    host threads for the native runtime
  --entropy {canonical,fgk}      v3 entropy mode (default: canonical)
  --lane N                       v3 canonical decode lane size (default: 512)
  --layout {global,sharded}      v3 transform layout; sharded enables
                                 random-access decode (default: global)
  --stats                        print a JSON metrics line (bpc, MB/s,
                                 chunks) to stderr after the run
  --dump-tables                  print the entropy coder's code tables /
                                 final FGK tree to stderr (the analogue
                                 of the reference's HuffTree::print)
"""

_LONG = ["backend=", "format=", "chunk-size=", "threads=",
         "entropy=", "lane=", "layout=", "stats", "dump-tables"]

# the reference's exit code of each of its error messages
_CODE_BY_MSG = {
    "invalid size of input 2D data": 6,
    "invalid or missing Huffman coding header": 8,
    "invalid Huffman coding file contents": 9,
    "invalid or missing adaptive block RLE header": 10,
    "invalid adaptive block RLE header": 11,
    "too small 2D data dimensions": 12,
    "invalid adaptive block RLE file contents": 13,
    "unexpected end of adaptive block RLE data": 14,
    "leftover data of adaptive block RLE detected": 15,
}


def _cerrh(msg: str) -> None:
    sys.stderr.write(msg)
    sys.stderr.write("try 'huffman-codec-tpu -h' for more information\n")


def main(argv: list[str] | None = None, device=None) -> int:
    """Run the command line on ``argv`` (``sys.argv[1:]`` by default) and
    return its exit code. ``device=None`` runs v3 and v1's default
    ``--backend torch`` on the CUDA device; ``device="cpu"`` on the plain PyTorch versions."""
    argv = sys.argv[1:] if argv is None else argv
    use_compr = True  # -c is the default operation
    use_diff = False
    use_adapt = False
    width = 512
    ifp = None
    ofp = "b.out"
    backend = "torch"  # the device; native and pyref run on the host
    fmt = "v1"
    chunk_size = 1 << 16
    threads = 0
    entropy = "canonical"
    lane = 512
    layout = "global"
    stats = False
    dump_tables = False

    try:
        opts, _ = getopt.getopt(argv, ":cdmai:o:w:h", _LONG)
    except getopt.GetoptError as e:
        if "requires argument" in str(e):
            _cerrh("ERROR: missing additional argument\n")
            return 1
        _cerrh("ERROR: unrecognized option used\n")
        return 2

    for opt, val in opts:
        if opt == "-c":
            use_compr = True
        elif opt == "-d":
            use_compr = False
        elif opt == "-m":
            use_diff = True
        elif opt == "-a":
            use_adapt = True
        elif opt == "-i":
            ifp = val
        elif opt == "-o":
            ofp = val
        elif opt == "-w":
            try:
                width = int(val)
            except ValueError:
                width = 0
        elif opt == "-h":
            sys.stdout.write(HELP_MESSAGE)
            return 0
        elif opt == "--backend":
            backend = val
        elif opt == "--format":
            fmt = val
        elif opt == "--chunk-size":
            chunk_size = int(val)
        elif opt == "--threads":
            threads = int(val)
        elif opt == "--entropy":
            entropy = val
        elif opt == "--lane":
            lane = int(val)
        elif opt == "--layout":
            layout = val
        elif opt == "--stats":
            stats = True
        elif opt == "--dump-tables":
            dump_tables = True

    if ifp is None:
        _cerrh("ERROR: no input file path provided\n")
        return 3
    if use_compr and width == 0:
        _cerrh("ERROR: invalid 2D data width\n")
        return 4
    try:
        with open(ifp, "rb") as f:
            data = f.read()
    except OSError:
        sys.stderr.write("ERROR: given input file does not exist\n")
        return 5

    t0 = time.perf_counter()
    try:
        out = _run(data, use_compr, use_diff, use_adapt, width, backend, fmt,
                   chunk_size, threads, entropy, lane, layout, device)
    except _CodecFailure as e:
        sys.stderr.write(f"ERROR: {e.message}\n")
        return e.code
    dt = time.perf_counter() - t0

    if dump_tables:
        blob = out if use_compr else data
        try:
            if blob[:6] == V3_MAGIC:
                dump_v3_tables(blob)
            else:
                dump_v1_tree(blob)
        except Exception as e:  # noqa: BLE001 — a debug aid, never fatal
            sys.stderr.write(f"dump-tables failed: {e}\n")

    if stats:
        raw_n, comp_n = (len(data), len(out)) if use_compr else (len(out),
                                                                 len(data))
        m = CodecMetrics(
            input_bytes=raw_n, output_bytes=comp_n,
            encode_s=dt if use_compr else 0.0,
            decode_s=0.0 if use_compr else dt,
            n_chunks=(-(-raw_n // chunk_size) if fmt in ("v2", "v3") else 0),
            extra={"format": fmt, "backend": backend, "op": "compress"
                   if use_compr else "decompress"})
        sys.stderr.write(m.to_json() + "\n")

    # the reference reports before it tries the write, so the stderr of
    # exit 7 holds both lines
    sys.stderr.write(f"writing {len(out)} bytes to {ofp}\n")
    try:
        with open(ofp, "wb") as f:
            f.write(out)
    except OSError:
        sys.stderr.write(f"ERROR: cannot write to {ofp} output file\n")
        return 7
    return 0


class _CodecFailure(Exception):
    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code
        self.message = message


def _run(data, use_compr, use_diff, use_adapt, width, backend, fmt,
         chunk_size, threads, entropy="canonical", lane=512,
         layout="global", device=None) -> bytes:
    if fmt == "v1" and backend == "native":
        try:
            runtime._load()
        except Exception:
            backend = "pyref"  # no C++ toolchain: the other host model
    try:
        if fmt == "v1":
            return _run_v1(data, use_compr, use_diff, use_adapt, width,
                           backend, threads, device)
        if fmt == "v2":
            if use_compr:
                return runtime.v2_compress(
                    data, use_diff, use_adapt, width, chunk_size, threads)
            return runtime.v2_decompress(data, threads)
        if fmt == "v3":
            codec = TorchCodec(CodecConfig(use_diff=use_diff,
                                           use_adapt=use_adapt, width=width,
                                           chunk_size=chunk_size,
                                           entropy=entropy, lane=lane,
                                           layout=layout), device=device)
            return codec.encode(data) if use_compr else codec.decode(data)
        raise _CodecFailure(2, "unrecognized container format")
    except _CodecFailure:
        raise
    except Exception as e:  # backend errors -> the reference's exit codes
        raise _to_failure(e) from e


def _run_v1(data, use_compr, use_diff, use_adapt, width, backend, threads,
            device=None):
    if backend == "native":
        if use_compr:
            return runtime.v1_compress(data, use_diff, use_adapt, width,
                                       n_threads=threads)
        return runtime.v1_decompress(data)
    if backend == "torch":
        codec = V1Codec(CodecConfig(use_diff=use_diff, use_adapt=use_adapt,
                                    width=width), device=device)
        return codec.encode(data) if use_compr else codec.decode(data)
    if backend == "pyref":
        if use_compr:
            return pyref.compress(data, use_diff, use_adapt, width)
        return pyref.decompress(data)
    raise _CodecFailure(2, "unrecognized backend")


def _to_failure(e: Exception) -> _CodecFailure:
    if isinstance(e, runtime.NativeError):
        return _CodecFailure(e.code, str(e))
    msg = str(e) or e.__class__.__name__
    for key, code in _CODE_BY_MSG.items():
        if key in msg:
            return _CodecFailure(code, key + " detected" if code == 6 else key)
    return _CodecFailure(9, msg)
