"""profile_port.py's kernel variants are textual edits of the committed CUDA
sources.  Each edit's text must still be in its source, or the variant
cannot be built on the card; this holds them to the sources on the CPU, and
builds the dense B=8 target's graphs on the CPU at a small size."""

import pytest

import profile_port as pp
from gcn_grabcut_torch import kernels

VARIANTS = ([("banded_spmm", f"k1-{i}", v)
             for i, v in enumerate(pp.K1_VARIANTS)]
            + [("ring_collectives", f"k2-{i}", v)
               for i, v in enumerate(pp.K2_VARIANTS)]
            + [("ring_collectives", f"k3-{i}", v)
               for i, v in enumerate(pp.K3_VARIANTS)]
            + [("segment_sum", f"seg-{i}", v)
               for i, v in enumerate(pp.SEGMENT_VARIANTS)]
            + [("grid_mincut", f"cut-{i}", v)
               for i, v in enumerate(pp.CUT_VARIANTS)]
            + [("slic_connectivity", f"slic-{i}", v)
               for i, v in enumerate(pp.SLIC_VARIANTS)]
            + [("mask_components", f"mask-{i}", v)
               for i, v in enumerate(pp.MASK_VARIANTS)])


@pytest.mark.parametrize("name,variant", [(n, v) for n, _, v in VARIANTS],
                         ids=[i for _, i, _ in VARIANTS])
def test_variant_edits_are_in_the_source(name, variant):
    label, edits = variant
    base = (kernels.CSRC / f"{name}.cu").read_text()
    src = pp.variant_source(name, label, edits)
    assert (src != base) == bool(edits)


def test_variant_source_raises_on_a_missing_edit():
    with pytest.raises(RuntimeError, match="not in ring_collectives.cu"):
        pp.variant_source("ring_collectives", "stale",
                          [("no such text", "")])


def test_ring_collectives_release_without_sc_fence():
    """Both collectives signal with st.release.sys alone; the fenced exit
    is only a variant that measures what a fence.sc.sys would cost."""
    code = "\n".join(line.split("//")[0] for line in (
        kernels.CSRC / "ring_collectives.cu").read_text().splitlines())
    assert "__threadfence_system" not in code and "fence.sc" not in code
    assert "__threadfence_system" in pp.variant_source(
        "ring_collectives", *pp.FENCED_EXIT)


def test_the_block_path_design_is_kept_with_its_interface():
    """profile_port times the design before the long blocks from its own
    source, through the C interface that design had."""
    src = open(pp.SEGMENT_BLOCK_PATH).read()
    assert "long_segment_kernel" in src
    assert ('extern "C" int segment_reduce(int dtype, int op, const void* '
            'values,') in src


def test_dense_target_builds_on_the_cpu():
    """The dense B=8 target (the recommended ensemble, bg_connectivity,
    ms_scales) at 96 px on the CPU: its pipeline builds the batch's graphs
    in one pass, with a leading B axis."""
    import numpy as np
    import torch
    from gcn_grabcut_torch.graph_build import build_graph_batch_arrays

    torch.set_num_threads(1)
    pipe, images, settings = pp.dense_target(device="cpu", hw=96,
                                             n_images=2)
    assert pipe.sp_config.bg_connectivity and settings["ms_scales"] == (
        1.0, 0.75)
    out = build_graph_batch_arrays(np.stack(images), pipe.sp_config,
                                   device="cpu")
    k = out["x"].shape[1]
    assert out["segments"].shape == (2, 96, 96) and out["x"].shape == (2, k,
                                                                       19)
    assert int(out["segments"].max()) < k
    assert bool(torch.isfinite(out["prior"]).all())
