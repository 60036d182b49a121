"""The port's sharding rules held to the reference's, exactly (specs are
data: no tolerance), on the CPU in one process.

* ``param_pspecs`` for all 13 registry configs in the modes ``train``,
  ``serve_tp`` and ``serve_2d``, every leaf: the port's spec for layer i's
  leaf equals the reference's (its ``prefix_layers[i]``, or its stacked
  ``scan_layers`` spec less the leading None of the stacked axis);
  ``opt_pspecs`` the same;
* ``data_pspecs`` and ``cache_pspecs`` on meshes of sizes (16, 16),
  (2, 16, 16), (1, 4) and (2, 2) for every config at the decode shapes:
  the port's ``DeviceMesh``es on a fake process group of the mesh's size
  (``torch.testing``'s ``FakeStore``, backend "fake"), the reference's
  ``AbstractMesh`` of the same sizes;
* ``choose_mode``, ``supports_shape`` and ``SHAPES``;
* the reference's ``test_pspec_divisibility_on_production_mesh`` on the
  port: ``make_production_mesh`` over 256 (and 512) fake ranks, every
  sharded dim divisible (``validate_divisibility`` empty);
* ``validate_divisibility`` reporting the reference's violations on a
  mesh that does not divide;
* ``RestoreDatapath.for_channels`` pinning its channels through
  ``io_channel_devices``, with a mesh and without;
* with no mesh: ``constrain`` returns its input object, every kernel
  wrapper refuses a DTensor that is not on the CPU before its device check
  (a ``meta`` DTensor shows it here), and ``make_local_mesh`` with its
  default device raises without a card.
"""
import contextlib
import types

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as JP

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402
from torch.testing._internal.distributed.fake_pg import FakeStore  # noqa: E402

from repro.config import SHAPES as J_SHAPES  # noqa: E402
from repro.config import supports_shape as j_supports  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import list_archs  # noqa: E402
from repro.distributed import elastic as j_elastic  # noqa: E402
from repro.distributed import sharding as jshr  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro_torch.config import SHAPES, supports_shape  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed import sharding as shr  # noqa: E402
from repro_torch.distributed.constraints import constrain, use_mesh  # noqa: E402
from repro_torch.distributed.elastic import validate_divisibility  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

ARCHS = list_archs()
MODES = ("train", "serve_tp", "serve_2d")
MESHES = {(16, 16): ("data", "model"), (2, 16, 16): ("pod", "data", "model"),
          (1, 4): ("data", "model"), (2, 2): ("data", "model")}
# (batch, seq) of the cache and data specs: the decode shapes and a small one
BATCH_SEQ = ((128, 32_768), (1, 524_288), (8, 32))


@contextlib.contextmanager
def fake_world(n: int):
    """A fake process group of ``n`` ranks (this process is rank 0)."""
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _device_mesh(shape):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", shape, mesh_dim_names=MESHES[shape])


def _jspecs(tree):
    return jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]


def _tspecs(tree):
    out = []
    shr._map_with_path(lambda path, s: out.append((path, s)), tree)
    return out


def _ref_model(arch):
    """The reference model with its ``param_specs`` traced once (the rules
    call it for every mode)."""
    jm = j_build(j_get_config(arch))
    specs = jm.param_specs()
    jm.param_specs = lambda: specs
    return jm


def _expected(jm, jtree):
    """The reference's specs as the port lays its tree out: per layer, the
    stacked spec less its leading None."""
    out = {}
    for path, spec in _jspecs(jtree):
        keys = [getattr(p, "key", getattr(p, "idx", None)) for p in path]
        if keys[0] == "scan_layers":
            assert tuple(spec)[0] is None
            for i in range(jm.prefix_len, jm.cfg.num_layers):
                out[("layers", str(i), *keys[1:])] = tuple(spec)[1:]
        elif keys[0] == "prefix_layers":
            out[("layers", str(keys[1]), *keys[2:])] = tuple(spec)
        else:
            out[tuple(str(k) for k in keys)] = tuple(spec)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_pspecs_match_reference(arch):
    jm = _ref_model(arch)
    tm = build_model(get_config(arch), device="cpu")
    for mode in MODES:
        want = _expected(jm, jshr.param_pspecs(jm, mode))
        got = {path: tuple(s) for path, s in _tspecs(shr.param_pspecs(tm, mode))}
        assert got == want, mode
        j_opt, t_opt = jshr.opt_pspecs(jm, mode), shr.opt_pspecs(tm, mode)
        assert tuple(t_opt.step) == tuple(j_opt.step) == ()
        for jt, tt in ((j_opt.m, t_opt.m), (j_opt.v, t_opt.v)):
            assert {p: tuple(s) for p, s in _tspecs(tt)} == _expected(jm, jt), mode


@pytest.mark.parametrize("shape", list(MESHES))
def test_data_and_cache_pspecs_match_reference(shape):
    n = int(np.prod(shape))
    jmesh = AbstractMesh(shape, MESHES[shape])
    with fake_world(n):
        mesh = _device_mesh(shape)
        assert tuple(mesh.mesh.shape) == shape
        assert shr.batch_axes(mesh) == jshr.batch_axes(jmesh)
        for arch in ARCHS:
            cfg_j, cfg_t = j_get_config(arch), get_config(arch)
            jm, tm = j_build(cfg_j), build_model(cfg_t, device="cpu")
            for b, s in BATCH_SEQ:
                for kind in ("train", "prefill", "decode"):
                    want = jshr.data_pspecs(cfg_j, jmesh, kind, b)
                    got = shr.data_pspecs(cfg_t, mesh, kind, b)
                    if isinstance(want, dict):
                        assert {k: tuple(v) for k, v in got.items()} == \
                            {k: tuple(v) for k, v in want.items()}, (arch, kind, b)
                    else:
                        assert tuple(got) == tuple(want), (arch, kind, b)
                want = jshr.cache_pspecs(jm, jmesh, b, s)
                got = shr.cache_pspecs(tm, mesh, b, s)
                assert {k: tuple(v) for k, v in got.items()} == \
                    {k: tuple(v) for k, v in want.items()}, (arch, b, s)


def test_to_placements():
    from torch.distributed.tensor import Replicate, Shard
    with fake_world(8):
        from torch.distributed.device_mesh import init_device_mesh
        mesh = init_device_mesh("cpu", (2, 2, 2), mesh_dim_names=("pod", "data", "model"))
        assert shr.to_placements(mesh, shr.P(("pod", "data"), None, "model")) == \
            [Shard(0), Shard(0), Shard(2)]
        assert shr.to_placements(mesh, shr.P(None, "data")) == \
            [Replicate(), Shard(1), Replicate()]
        assert shr.to_placements(mesh, shr.P()) == [Replicate()] * 3


def test_choose_mode_shapes_and_supports_shape():
    assert SHAPES == {k: type(SHAPES[k])(**vars(v)) for k, v in J_SHAPES.items()}
    for arch in ARCHS:
        cfg_j, cfg_t = j_get_config(arch), get_config(arch)
        for name in SHAPES:
            assert supports_shape(cfg_t, SHAPES[name]) == j_supports(cfg_j, J_SHAPES[name])
            assert shr.choose_mode(cfg_t, SHAPES[name]) == \
                jshr.choose_mode(cfg_j, J_SHAPES[name]), (arch, name)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_pspec_divisibility_on_production_mesh(multi_pod):
    """Every sharded dim divides the production mesh's dims (the
    reference's test on the port, for its four archs in every mode)."""
    n = 512 if multi_pod else 256
    with fake_world(n):
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        assert mesh.mesh_dim_names == (("pod", "data", "model") if multi_pod
                                       else ("data", "model"))
        assert tuple(mesh.mesh.shape) == ((2, 16, 16) if multi_pod else (16, 16))
        for arch in ("phi4-mini-3.8b", "deepseek-v2-236b", "recurrentgemma-2b", "rwkv6-7b"):
            tm = build_model(get_config(arch), param_dtype=torch.bfloat16, device="cpu")
            tree = tm.param_specs()
            for mode in MODES:
                assert validate_divisibility(tree, shr.param_pspecs(tm, mode), mesh) == [], \
                    (arch, mode)


def test_validate_divisibility_matches_reference():
    """A d_ff and vocabulary the "model" dim of 4 does not divide: the same
    violations as the reference's, its stacked layers' one per port layer
    (one dim lower)."""
    over = dict(num_heads=4, num_kv_heads=4, d_model=128, d_ff=250, vocab_size=510)
    jm = j_build(j_get_config("qwen1.5-0.5b").reduced(**over))
    tm = build_model(get_config("qwen1.5-0.5b").reduced(**over), device="cpu")
    want = set()
    for path, dim, ax in j_elastic.validate_divisibility(
            jm.param_specs(), jshr.param_pspecs(jm, "train"),
            types.SimpleNamespace(shape={"data": 1, "model": 4})):
        if path.startswith("['scan_layers']"):
            want |= {(f"['layers'][{i}]" + path[len("['scan_layers']"):], dim - 1, ax)
                     for i in range(jm.prefix_len, jm.cfg.num_layers)}
        else:
            want.add((path, dim, ax))
    assert want
    with fake_world(4):
        mesh = _device_mesh((1, 4))
        got = validate_divisibility(tm.param_specs(), shr.param_pspecs(tm, "train"), mesh)
    assert len(got) == len(want) and set(got) == want


def test_datapath_pins_channels_through_io_channel_devices():
    """``RestoreDatapath.for_channels``: channel c on
    ``io_channel_devices(mesh, io_channels)[c]``; with no mesh every channel
    a queue of its own on the one device."""
    from repro_torch.core.datapath import RestoreDatapath
    dp = RestoreDatapath.for_channels(3, device="cpu")
    assert [s.device for s in dp.streams] == [torch.device("cpu")] * 3
    assert len({id(s) for s in dp.streams}) == 3
    assert len(RestoreDatapath.for_channels(0, device="cpu").streams) == 1
    with fake_world(4):
        mesh = _device_mesh((2, 2))
        dp = RestoreDatapath.for_channels(6, mesh, device="cpu")
        assert [s.device for s in dp.streams] == shr.io_channel_devices(mesh, 6)
        assert shr.io_channel_ranks(mesh, 6) == [0, 1, 2, 3, 0, 1]
        assert len(RestoreDatapath.for_channels(None, mesh, device="cpu").streams) == 4


def test_constrain_without_a_mesh_is_the_identity():
    x = torch.randn(4, 8)
    assert constrain(x, "data", "model") is x
    with fake_world(4):
        mesh = _device_mesh((2, 2))
        with use_mesh(mesh):
            assert constrain(x, "data", "model") is x        # a plain tensor
        from torch.distributed.tensor import DTensor, Replicate
        dt = DTensor.from_local(x, mesh, [Replicate(), Replicate()], run_check=False)
        assert constrain(dt, "data", "model") is dt          # no ambient mesh


def _wrapper_calls():
    from repro_torch.kernels.flash_decode import flash_decode, flash_decode_partials
    from repro_torch.kernels.flash_prefill import flash_prefill
    from repro_torch.kernels.kv_quant import kv_dequantize, kv_quantize
    from repro_torch.kernels.kv_restore import kv_restore_scatter
    from repro_torch.kernels.rglru_scan import rglru_scan
    from repro_torch.kernels.rwkv6_scan import wkv6, wkv6_backward

    def m(*shape, dtype=torch.bfloat16):
        return torch.zeros(shape, dtype=dtype, device="meta")
    kpos = m(64, dtype=torch.int32)
    rw = [m(1, 4, 2, 64, dtype=torch.float32) for _ in range(4)]
    rw += [m(2, 64, dtype=torch.float32), m(1, 2, 64, 64, dtype=torch.float32)]
    return {
        "flash_decode": (flash_decode, (m(2, 8, 128), m(2, 64, 2, 128), m(2, 64, 2, 128), kpos, 3),
                         {"scale": 0.1}),
        "flash_decode_partials": (flash_decode_partials, (m(2, 8, 128), m(2, 64, 2, 128),
                                                          m(2, 64, 2, 128), kpos, 3),
                                  {"scale": 0.1}),
        "flash_prefill": (flash_prefill, (m(1, 4, 8, 128), m(1, 64, 2, 128), m(1, 64, 2, 128),
                                          kpos, 3), {"scale": 0.1}),
        "kv_quantize": (kv_quantize, (m(16, 1024),), {}),
        "kv_dequantize": (kv_dequantize, (m(16, 1024, dtype=torch.int8),
                                          m(1024, dtype=torch.float32)), {}),
        "kv_restore": (kv_restore_scatter, ([m(2, 64, 1024)], [m(2, 16, 1024)]),
                       {"t0": 0, "chunk_size": 16}),
        "rglru_scan": (rglru_scan, (m(1, 8, 256, dtype=torch.float32),
                                    m(1, 8, 256, dtype=torch.float32),
                                    m(1, 256, dtype=torch.float32)), {}),
        "wkv6": (wkv6, tuple(rw), {}),
        "wkv6_backward": (wkv6_backward, tuple(rw) + (rw[0],), {}),
    }


@pytest.mark.parametrize("name", sorted(_wrapper_calls()))
def test_kernel_wrappers_refuse_a_dtensor_off_the_cpu(name):
    """A CUDA kernel takes a rank's local tensor: every wrapper refuses a
    DTensor before its device check (meta here; CUDA on the card)."""
    from torch.distributed.tensor import DTensor, Replicate
    fn, args, kw = _wrapper_calls()[name]
    with fake_world(4):
        mesh = _device_mesh((2, 2))

        def wrap(t):
            if isinstance(t, list):
                return [wrap(u) for u in t]
            if isinstance(t, torch.Tensor):
                return DTensor.from_local(t, mesh, [Replicate(), Replicate()], run_check=False)
            return t
        with pytest.raises(TypeError, match="not a DTensor"):
            fn(*(wrap(a) for a in args), **kw)


def test_mesh_entry_points_default_to_the_card():
    """make_local_mesh()'s default device is CUDA: without a card it raises
    (the tests pass device="cpu"); importing launch.mesh touched nothing."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is what this CPU test checks")
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="cuda"):
        make_local_mesh()
    with fake_world(4):
        mesh = make_local_mesh(2, 2, device="cpu")
        assert mesh.mesh_dim_names == ("data", "model") and tuple(mesh.mesh.shape) == (2, 2)
        with pytest.raises(RuntimeError, match="ranks"):
            make_local_mesh(1, 2, device="cpu")
