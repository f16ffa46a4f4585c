"""The nodes of a captured CUDA graph, read through the CUDA driver API
(``libcuda``, by ctypes): what a captured loop body runs on the device an
iteration.  Nothing here launches the graph."""
from __future__ import annotations

import ctypes
from collections import Counter

# CUgraphNodeType
TYPES = ("kernel", "memcpy", "memset", "host", "graph", "empty", "wait_event", "event_record",
         "ext_semas_signal", "ext_semas_wait", "mem_alloc", "mem_free", "batch_mem_op",
         "conditional")
DEVICE = ("kernel", "memcpy", "memset")


def node_types(raw_graph: int) -> Counter:
    """The nodes of the graph ``raw_graph`` (a ``cudaGraph_t``, as
    ``torch.cuda.CUDAGraph.raw_cuda_graph()`` gives it) by type, the nodes
    of its child graphs counted in their place."""
    cu = ctypes.CDLL("libcuda.so.1")
    out: Counter = Counter()

    def check(err, what):
        if err:
            raise RuntimeError(f"{what}: CUDA driver error {err}")

    def walk(graph):
        count = ctypes.c_size_t(0)
        check(cu.cuGraphGetNodes(graph, None, ctypes.byref(count)), "cuGraphGetNodes")
        nodes = (ctypes.c_void_p * count.value)()
        check(cu.cuGraphGetNodes(graph, nodes, ctypes.byref(count)), "cuGraphGetNodes")
        for node in map(ctypes.c_void_p, nodes):
            kind = ctypes.c_int(-1)
            check(cu.cuGraphNodeGetType(node, ctypes.byref(kind)), "cuGraphNodeGetType")
            name = TYPES[kind.value] if 0 <= kind.value < len(TYPES) else str(kind.value)
            if name == "graph":
                child = ctypes.c_void_p()
                check(cu.cuGraphChildGraphNodeGetGraph(node, ctypes.byref(child)),
                      "cuGraphChildGraphNodeGetGraph")
                walk(child)
            else:
                out[name] += 1

    walk(ctypes.c_void_p(raw_graph))
    return out
