"""The dry-run's input stand-ins (``repro_torch.launch.specs``) against
the reference's (``repro/launch/specs.py``):

* for all 40 arch x shape pairs, every stand-in's name, shape and dtype
  equal the reference's ``ShapeDtypeStruct`` s, and the decode cache the
  reference's ``jax.eval_shape`` of ``init_cache`` (meta tensors: nothing
  is allocated on either side);
* the cell list and its skips equal the reference's
  ``cell_is_runnable``;
* a rank's rows equal the reference's batch sharding on the production
  grids, and a rank's cache is the whole one at those rows, cut to the
  rank's kv heads (or one kv head where they are fewer than the ranks,
  ROADMAP C31), SSM channels or RG-LRU width;
* ``init_cache`` and ``init_pages`` take the meta device while
  ``resolve_device`` still refuses it.
"""

import jax
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.launch import specs as jspecs
from repro.models import transformer as jtf
from repro.sharding import rules as jrules
from repro_torch.configs import SHAPES, all_configs, cell_is_runnable
from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.launch import specs
from repro_torch.launch.mesh import production_grid
from repro_torch.models import init_cache
from repro_torch.models.paged import init_pages
from repro_torch.sharding import rules

ARCHS = sorted(all_configs())
CELLS = [(a, s) for a in ARCHS for s in SHAPES]


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return str(np.dtype(dtype))


def _spec_dict(tree):
    return {k: (tuple(v.shape), _dtype_name(v.dtype)) for k, v in
            tree.items()}


def test_forty_cells_and_their_skips_equal_the_reference():
    assert len(CELLS) == 40
    assert sorted(jconfigs.all_configs()) == ARCHS
    assert list(jconfigs.SHAPES) == list(SHAPES)
    for arch, shape in CELLS:
        got = cell_is_runnable(get_config(arch), SHAPES[shape])
        want = jconfigs.cell_is_runnable(jconfigs.get_config(arch),
                                         jconfigs.SHAPES[shape])
        assert got == want, (arch, shape)
    skipped = [c for c in CELLS
               if not cell_is_runnable(get_config(c[0]), SHAPES[c[1]])[0]]
    assert len(skipped) == 8
    assert all(s == "long_500k" for _, s in skipped)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_stand_ins_equal_the_reference(arch, shape):
    cfg, jcfg = get_config(arch), jconfigs.get_config(arch)
    sh, jsh = SHAPES[shape], jconfigs.SHAPES[shape]
    if sh.step == "train":
        got, want = (specs.train_input_specs(cfg, sh),
                     jspecs.train_input_specs(jcfg, jsh))
    elif sh.step == "prefill":
        got, want = (specs.prefill_input_specs(cfg, sh),
                     jspecs.prefill_input_specs(jcfg, jsh))
    else:
        got, want = (specs.decode_input_specs(cfg, sh),
                     jspecs.decode_input_specs(jcfg, jsh))
        cache = specs.decode_cache_specs(cfg, sh)
        assert _spec_dict(cache) == _spec_dict(
            jspecs.decode_cache_specs(jcfg, jsh))
        assert all(v.is_meta for k, v in cache.items() if k != "pos")
    assert _spec_dict(got) == _spec_dict(want)
    assert _spec_dict(specs.input_specs(cfg, sh)) == _spec_dict(got)
    assert all(v.is_meta for v in got.values())


def test_whisper_conventions_are_the_reference_s():
    assert specs.WHISPER_DECODER_PROMPT == jspecs.WHISPER_DECODER_PROMPT
    assert specs.WHISPER_DECODE_CROSS_LEN == jspecs.WHISPER_DECODE_CROSS_LEN


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_rank_rows_follow_the_reference_batch_sharding(multi_pod, shape):
    shp, names = production_grid(multi_pod=multi_pod)
    policy = rules.for_grid((names, shp))
    jpolicy = jrules.ShardingPolicy(
        data_axes=tuple(a for a in ("pod", "data") if a in names),
        axis_sizes=tuple(zip(names, shp)))
    cfg = get_config("mistral-nemo-12b")
    whole = specs.input_specs(cfg, SHAPES[shape])
    want = jrules.batch_sharding_specs(jpolicy, whole)
    got = specs.rank_batch_specs(policy, whole)
    for key, x in whole.items():
        rows = x.shape[0] // jpolicy.axis_size(want[key][0])
        assert tuple(got[key].shape) == (rows,) + tuple(x.shape[1:])
        assert got[key].dtype == x.dtype
    if shape == "long_500k":      # one row: whole on every rank
        assert got["tokens"].shape[0] == 1


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
def test_rank_cache_is_the_whole_one_cut(arch, shape):
    cfg, sh = get_config(arch), SHAPES[shape]
    shp, names = production_grid()
    policy = rules.for_grid((names, shp))
    m = policy.axis_size("model")
    rows = specs.rank_rows(policy, sh.global_batch)
    whole = specs.decode_cache_specs(cfg, sh)
    local = specs.rank_cache_specs(cfg, sh, policy)
    assert set(local) == set(whole)
    for key, x in whole.items():
        if key == "pos":
            assert local[key].shape == () and local[key].dtype == torch.int32
            continue
        want = list(x.shape)
        want[1] = rows
        if key in ("k", "v", "enc_k", "enc_v"):
            kv = rules.padded_heads(cfg, m)[1]           # padded (C33)
            want[3] = kv // m if kv % m == 0 else 1      # C31: one kv head
        elif key == "conv":
            want[3] //= m
        elif key == "h":
            want[2] //= m
        assert list(local[key].shape) == want, (key, local[key].shape)
        assert local[key].dtype == x.dtype and local[key].is_meta


def test_meta_caches_and_pools_allocate_nothing():
    cfg = get_config("yi-34b")
    cache = init_cache(cfg, 128, 32768, device="meta", tp=4)
    assert cache["k"].is_meta and cache["k"].shape == (60, 128, 32768, 2,
                                                       128)
    jcache = jax.eval_shape(lambda: jtf.init_cache(
        jconfigs.get_config("yi-34b"), 128, 32768))
    assert jcache["k"].shape[:3] == cache["k"].shape[:3]
    pages = init_pages(cfg, 64, 16, device="meta", tp=4)
    assert pages["k"].is_meta and pages["k"].shape == (60, 64, 16, 2, 128)
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        init_cache(cfg.reduced(), 1, 8, device="xpu")
