"""The port at shapes that are not multiples of 16, against the JAX
package on the CPU: chunks of 1000 bytes, lanes of 100 and 8 symbols.
The port's containers are byte-equal to ``TPUCodec``'s and each package
decodes the other's. On a GPU the same configs run every kernel (the CUDA
tests in ``tests/test_torch_gpu.py`` and ``chip_smoke.py``'s shapes
phase); here the plain versions run, as they do for every CPU tensor.

Four JAX configs, each compiled once for one input length of at most
5000 bytes: sharded 1000/100 with and without the diff model, sharded
lane 8 with it, and the global layout at 1000/100, whose chunked
candidate is also what ``whole_file=False`` encodes. The global layout's
``encode()`` would keep the smaller v1 blob at this size, so its v3
candidates are compared directly. Every port container is byte-equal to
JAX's, so the JAX decoder runs on one port container of each layout
(each decode compiles anew), the port decoder on all of JAX's. Also the
host-side helpers of the kernel launches: the fat-lane decoder's
sub-sequence size and the repad kernel's scratch size.
"""

import dataclasses

import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from huffman_codec_tpu.models import chunked as jch  # noqa: E402
from huffman_codec_tpu_torch import TorchCodec, config_from_fields  # noqa: E402
from huffman_codec_tpu_torch.edge_cases import (  # noqa: E402
    ODD_CONFIGS, odd_config_input)
from huffman_codec_tpu_torch.ops import kernels as K  # noqa: E402


def _jcfg(name, use_diff, **kw):
    return jch.CodecConfig(use_diff=use_diff, **ODD_CONFIGS[name], **kw)


def _port(jcfg):
    return TorchCodec(config_from_fields(dataclasses.asdict(jcfg)),
                      device="cpu")


SHARDED = [("sharded-1000-100", False), ("sharded-1000-100", True),
           ("sharded-lane-8", True)]


@pytest.fixture(scope="module")
def jax_sharded():
    return {(name, d): jch.TPUCodec(_jcfg(name, d)).encode(
        odd_config_input(name)) for name, d in SHARDED}


@pytest.mark.parametrize("name,use_diff", SHARDED)
def test_sharded_container_is_byte_equal_to_jax(jax_sharded, name, use_diff):
    got = _port(_jcfg(name, use_diff)).encode(odd_config_input(name))
    assert got == jax_sharded[(name, use_diff)]


@pytest.mark.parametrize("name,use_diff", SHARDED)
def test_port_decodes_jax_sharded_container(jax_sharded, name, use_diff):
    # a JAX-made container of 1000-byte chunks: out_len 1000 on a card
    port = _port(_jcfg(name, use_diff))
    assert port.decode(jax_sharded[(name, use_diff)]) == odd_config_input(name)
    if name == "sharded-1000-100":
        got = port.decode_range(jax_sharded[(name, use_diff)], 990, 1020)
        assert got == odd_config_input(name)[990:2010]


@pytest.mark.parametrize("name,use_diff", [("sharded-1000-100", True)])
def test_jax_decodes_port_sharded_container(name, use_diff):
    blob = _port(_jcfg(name, use_diff)).encode(odd_config_input(name))
    assert jch.TPUCodec(_jcfg(name, use_diff)).decode(blob) == \
        odd_config_input(name)


@pytest.fixture(scope="module")
def jax_global():
    data = odd_config_input("global-1000-100")
    jc = jch.TPUCodec(_jcfg("global-1000-100", True))
    return {w: jc._encode_global(data, None, w) for w in (True, False)}


@pytest.mark.parametrize("whole_file", [True, False])
def test_global_candidates_are_byte_equal_to_jax(jax_global, whole_file):
    data = odd_config_input("global-1000-100")
    port = _port(_jcfg("global-1000-100", True, whole_file=whole_file))
    cands = port.global_candidates(len(data))
    assert cands == ([True, False] if whole_file else [False])
    for w in cands:
        blob = port._encode_global(data, None, w)
        assert blob == jax_global[w]
        assert port.decode(blob) == data
    # whole_file=False keeps the configured lane 100 (2048 does not
    # divide a 1000-byte chunk either way)
    assert port._parse(jax_global[False])["lane"] == 100


@pytest.mark.parametrize("whole", [True, False])
def test_each_package_decodes_the_others_global_candidate(jax_global, whole):
    data = odd_config_input("global-1000-100")
    jcfg = _jcfg("global-1000-100", True)
    port = _port(jcfg)
    assert port.decode(jax_global[whole]) == data
    if not whole:  # lane 100 in the JAX decoder
        blob = port._encode_global(data, None, whole)
        assert jch.TPUCodec(jcfg).decode(blob) == data


def test_encode_keeps_v1_below_the_race_gate():
    # the global layout's encode() at this size: the smaller of v1 and v3,
    # the same blob in both packages
    data = odd_config_input("global-1000-100")
    jcfg = _jcfg("global-1000-100", True)
    blob = _port(jcfg).encode(data)
    assert blob == jch.TPUCodec(jcfg).encode(data)
    assert _port(jcfg).decode(blob) == data


@pytest.mark.parametrize("wb,bits", [
    (8, 96), (64, 96), (3072, 96), (3073, 160), (3232, 160), (8192, 288),
    (31872, 1056)])
def test_fat_subseq_bits(wb, bits):
    # an odd number of words, at least 3, and FAT_THREADS of them cover
    # wb words; the fewest such
    s = K.fat_subseq_bits(wb)
    assert s == bits
    assert s % 64 == 32 and s >= 96
    assert s * K.FAT_THREADS >= 32 * wb
    assert s == 96 or (s - 64) * K.FAT_THREADS < 32 * wb


@pytest.mark.parametrize("C,nl,wb,words", [
    (1, 112, 6592, 181), (256, 172, 64, 688), (7, 45, 37, 3), (0, 5, 64, 0)])
def test_repad_scratch_words(C, nl, wb, words):
    # a status word a block of REPAD_SPAN output slots
    assert K.repad_scratch_words(C, nl, wb) == words
    assert words * K.REPAD_SPAN >= C * nl * wb
    assert words == 0 or (words - 1) * K.REPAD_SPAN < C * nl * wb
