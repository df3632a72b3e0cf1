"""pegasus_tpu_torch: the PyTorch/CUDA port of pegasus_tpu's LSM engine
device lane, for NVIDIA Hopper (H100, sm_90a).

The package mirrors pegasus_tpu's layout (base/, engine/, ops/, meta/,
replication/, rpc/, client/, runtime/, server/) so each module has a
counterpart of the same name. What it covers today: flush, manual and L0
compaction through the hand-written merge-path CUDA kernel
(csrc/merge_path.cu, ops/merge_path.py), and device-served point and
range reads through the fence-lookup CUDA kernel (csrc/fence_lookup.cu,
ops/device_lookup.py), driven through engine.LsmEngine; the serving
stack above it, PacificA replication and the cluster (meta server,
replica nodes, meta-resolved client). Its MANIFEST and SST files are
those of pegasus_tpu, its compaction output is byte-identical to
pegasus_tpu's, and so is every message on its wire.

Rules of the port:
  - It imports torch and numpy, never jax, and nothing of pegasus_tpu (not
    even its host-only modules or native extensions): it keeps its own
    copies of what it needs. Its host loops (CRC-64, prefix packing, the
    output gathers, the cpu merge's ranks) are its own C++
    (csrc/hostops.cpp, bound in native/), each with a numpy twin.
  - The device is explicit: EngineOptions(backend="cuda", device=None) and
    CompactOptions(device=None), where None means torch.device("cuda").
    Tests pass device="cpu".
  - No fallback: on a CUDA tensor a kernel launches or raises, and a
    device failure propagates to the caller. The cpu backend
    (backend="cpu") runs only when the caller asks for it; on CPU tensors
    the kernels' plain PyTorch versions run.
  - CUDA and C++ sources build at first use (ops/_build.py) into
    <repo>/.torch_ext/; a failed build raises.
  - carry.py turns pegasus_tpu's resident runs (as numpy) into the port's.
"""
