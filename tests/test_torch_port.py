"""Rules of the PyTorch port that hold whatever the numbers:

* no module of ``src/repro_torch`` nor ``chip_smoke.py`` imports ``jax`` or
  anything of the reference package ``repro``;
* entry points default to CUDA and raise without it (nothing carries on on
  the CPU unasked);
* a kernel wrapper runs its plain version only for a CPU tensor, counts
  launches only when it launches the kernel, and never falls back to the
  plain version for a tensor on another device;
* importing the port builds nothing.
"""
import pathlib

import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis.codelint import check_no_reference_import  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.datapath import RestoreDatapath  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_decode import flash_decode  # noqa: E402
from repro_torch.kernels.flash_prefill import flash_prefill  # noqa: E402
from repro_torch.kernels.kv_quant import kv_dequantize, kv_quantize  # noqa: E402
from repro_torch.kernels.kv_restore import kv_restore_scatter  # noqa: E402
from repro_torch.kernels.rglru_scan import rglru_scan  # noqa: E402
from repro_torch.kernels.rwkv6_scan import wkv6  # noqa: E402
from repro_torch.launch.serve import main as serve_main  # noqa: E402
from repro_torch.models import Model, params_from_jax  # noqa: E402
from repro_torch.serving import ChunkStore, RealServingEngine  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_reference(path):
    """The codelint rule no-reference-import, file by file."""
    bad = check_no_reference_import([path])
    assert not bad, [str(f) for f in bad]


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")


@pytest.mark.parametrize("entry", ["model", "store", "datapath", "params", "engine",
                                   "serve_real"])
def test_default_device_entry_points_raise_without_cuda(entry):
    _no_cuda()
    cfg = get_config("qwen3-8b").reduced()
    with pytest.raises(RuntimeError, match="cuda"):
        if entry == "model":
            Model(cfg)
        elif entry == "store":
            ChunkStore()
        elif entry == "datapath":
            RestoreDatapath.for_channels(1)
        elif entry == "params":
            params_from_jax({"embed": [[0.0]]})
        elif entry == "serve_real":
            serve_main(["--real", "--requests", "1"])
        else:
            m = Model(cfg, device="cpu")
            RealServingEngine(m, m.init(torch.Generator().manual_seed(0)))


def _attention_inputs(dev="cpu"):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 3, 4, 32, generator=g)
    k = torch.randn(1, 8, 2, 32, generator=g)
    kpos = torch.arange(8, dtype=torch.int32)
    return [t.to(dev) for t in (q, k, k.clone(), kpos)]


# the inputs each kernel of the dry run's path takes (shape, dtype)
_BF, _F = torch.bfloat16, torch.float32
META_ROUTE = {
    "flash_prefill": [((1, 3, 4, 64), _BF), ((1, 8, 2, 64), _BF), ((1, 8, 2, 64), _BF),
                      ((8,), torch.int32)],
    "flash_decode": [((1, 4, 64), _BF), ((1, 8, 2, 64), _BF), ((1, 8, 2, 64), _BF),
                     ((8,), torch.int32)],
    "rglru_scan": [((1, 3, 32), _F), ((1, 3, 32), _F), ((1, 32), _F)],
    "wkv6": [((1, 3, 2, 32), _F)] * 4 + [((2, 32), _F), ((1, 2, 32, 32), _F)],
}


def _meta_call(kernel, ins):
    if kernel == "flash_prefill":
        return flash_prefill(*ins, 5, scale=0.2)
    if kernel == "flash_decode":
        return flash_decode(*ins, 7, scale=0.2)
    if kernel == "rglru_scan":
        return rglru_scan(*ins)
    return wkv6(*ins)


@pytest.mark.parametrize("kernel", ["flash_prefill", "flash_decode", "kv_restore",
                                    "kv_quantize", "kv_dequantize", "rglru_scan",
                                    "wkv6"])
def test_wrappers_plain_on_cpu_only(kernel):
    """CPU tensors take the plain version and count no launch; on the meta
    device the kernels of the dry run's path take their meta route (empty
    meta outputs of the plain version's shapes and dtypes, no launch) and
    the store kernels refuse, so nothing is silently computed."""
    def call(dev):
        q, k, v, kpos = _attention_inputs(dev)
        if kernel == "flash_prefill":
            return flash_prefill(q, k, v, kpos, 5, scale=0.2)
        if kernel == "flash_decode":
            return flash_decode(q[:, 0], k, v, kpos, 7, scale=0.2)
        if kernel == "kv_restore":
            return kv_restore_scatter([k.reshape(1, 8, 64)], [v.reshape(1, 8, 64)],
                                      t0=0, chunk_size=8)
        if kernel == "kv_quantize":
            return kv_quantize(k)
        if kernel == "rglru_scan":
            return rglru_scan(q[:, :, 0], q[:, :, 1], q[:, 0, 2])
        if kernel == "wkv6":
            r = q[..., :2, :]                     # (1, 3, 2, 32)
            s0 = torch.zeros(1, 2, 32, 32, device=dev)
            return wkv6(r, r, r, torch.sigmoid(r), q[0, 0, :2], s0)
        return kv_dequantize(k.to(torch.int8), torch.ones(32, device=dev))

    wrappers = {"flash_prefill": flash_prefill, "flash_decode": flash_decode,
                "kv_restore": kv_restore_scatter, "kv_quantize": kv_quantize,
                "kv_dequantize": kv_dequantize, "rglru_scan": rglru_scan,
                "wkv6": wkv6}
    before = wrappers[kernel].launches
    call("cpu")
    assert wrappers[kernel].launches == before
    if kernel in META_ROUTE:
        ins = [torch.empty(shape, dtype=dt, device="meta") for shape, dt in META_ROUTE[kernel]]
        got = _meta_call(kernel, ins)
        plain = _meta_call(kernel, [torch.zeros(t.shape, dtype=t.dtype) for t in ins])
        for a, b in zip(*((x,) if isinstance(x, torch.Tensor) else x for x in (got, plain))):
            assert (a.device.type, a.shape, a.dtype) == ("meta", b.shape, b.dtype)
    else:
        with pytest.raises(ValueError, match="CUDA"):
            call("meta")
    assert wrappers[kernel].launches == before


def test_import_builds_nothing():
    assert _build._lib is None
    assert _build.CSRC.is_dir() and sorted(p.name for p in _build.CSRC.glob("*.cu")) == [
        "flash_decode.cu", "flash_prefill.cu", "kv_quant.cu", "kv_restore.cu",
        "rglru_scan.cu", "wkv6.cu", "wkv6_bwd.cu"]
