"""A frozen copy of gcn_grabcut_torch's plain PyTorch paths, the
benchmark's reference.

Copied from the program as it stood when the benchmark was defined:
core/, ops/ (image, slic, region, edges, prior, gmm, threefry, maxflow,
connected, spmm), graph_build.py, grabcut.py, models/ and
train/checkpoints.py (the msgpack decoder), cut to what
`bench_port.reference.pipeline.segment` runs: ResGCNNet only, no training
code.  Every CUDA kernel and its dispatch is taken out: each op runs its
plain version on any device (SLIC's connectivity repair, the fixed-order
segment sums, the banded SpMM, the push-relabel min-cut, the mask
components), so on the card this package runs eager PyTorch only.
Nothing here imports the program, and later changes to the program do
not reach it.
"""
