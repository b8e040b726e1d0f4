"""CSR representations, including the paper's custom §4.3 layout.

`CSRGraph` is the working in-memory format (numpy). `CustomCSR` is a
byte-accurate implementation of the paper's DRAM layout:

  * 512-bit data chunks;
  * pointer_data: one 96-bit entry per adjacency row =
      (chunk_id u32, chunk_offset u32, num_edges u32); five entries per
      chunk (480 bits used, 32 padding);
  * graph_data: 64-bit edge entries = (col_index u32, weight f32/u32);
      eight edges per chunk.

The FPGA streams chunks; the chunk accounting is what the fig-level
benchmarks use to model DRAM traffic (§5.11). numpy only, and byte for byte
the JAX package's ``repro.graph.csr``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

CHUNK_BYTES = 64  # 512 bits
PTR_ENTRY_BYTES = 12  # 96 bits
PTRS_PER_CHUNK = 5  # 5 * 96 = 480 bits used per chunk
EDGE_ENTRY_BYTES = 8  # 64 bits
EDGES_PER_CHUNK = 8


@dataclasses.dataclass
class CSRGraph:
    """Standard CSR of an undirected weighted graph (both directions stored)."""

    row: np.ndarray  # int64 [n+1]
    col: np.ndarray  # int32 [m]
    val: np.ndarray  # float32 [m]

    @property
    def n(self) -> int:
        return self.row.shape[0] - 1

    @property
    def m(self) -> int:
        return self.col.shape[0]

    @staticmethod
    def from_edges(src, dst, weight, n: int, symmetrize: bool = False) -> "CSRGraph":
        src = np.asarray(src, np.int64)
        dst = np.asarray(dst, np.int64)
        weight = np.asarray(weight, np.float32)
        if symmetrize:
            src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
            weight = np.concatenate([weight, weight])
        order = np.lexsort((dst, src))
        src, dst, weight = src[order], dst[order], weight[order]
        row = np.zeros(n + 1, np.int64)
        np.add.at(row, src + 1, 1)
        row = np.cumsum(row)
        return CSRGraph(row=row, col=dst.astype(np.int32), val=weight)

    def to_stream_arrays(self):
        """(src, dst, weight) in CSR row-major order — the paper's stream order."""
        src = np.repeat(np.arange(self.n, dtype=np.int64), np.diff(self.row))
        return src, self.col.astype(np.int64), self.val

    def neighbors(self, u: int):
        s, e = self.row[u], self.row[u + 1]
        return self.col[s:e], self.val[s:e]


@dataclasses.dataclass
class CustomCSR:
    """The paper's custom CSR (§4.3), byte-accurate."""

    pointer_data: np.ndarray  # uint8 [ptr_chunks * 64]
    graph_data: np.ndarray  # uint8 [edge_chunks * 64]
    n: int
    m: int

    @staticmethod
    def encode(csr: CSRGraph) -> "CustomCSR":
        n, m = csr.n, csr.m
        # --- pointer_data ---
        ptr_chunks = (n + PTRS_PER_CHUNK - 1) // PTRS_PER_CHUNK
        pbuf = np.zeros(ptr_chunks * CHUNK_BYTES, np.uint8)
        counts = np.diff(csr.row).astype(np.uint32)
        starts = csr.row[:-1].astype(np.uint64)
        chunk_id = (starts // EDGES_PER_CHUNK).astype(np.uint32)
        chunk_off = (starts % EDGES_PER_CHUNK).astype(np.uint32)
        entry = np.zeros((n, 3), np.uint32)
        entry[:, 0] = chunk_id
        entry[:, 1] = chunk_off
        entry[:, 2] = counts
        ebytes = entry.view(np.uint8).reshape(n, PTR_ENTRY_BYTES)
        for i in range(n):
            c, slot = divmod(i, PTRS_PER_CHUNK)
            off = c * CHUNK_BYTES + slot * PTR_ENTRY_BYTES
            pbuf[off : off + PTR_ENTRY_BYTES] = ebytes[i]
        # --- graph_data ---
        edge_chunks = (m + EDGES_PER_CHUNK - 1) // EDGES_PER_CHUNK
        gbuf = np.zeros(edge_chunks * CHUNK_BYTES, np.uint8)
        ent = np.zeros((m, 2), np.uint32)
        ent[:, 0] = csr.col.astype(np.uint32)
        ent[:, 1] = csr.val.view(np.uint32) if csr.val.dtype == np.float32 else csr.val
        gbuf[: m * EDGE_ENTRY_BYTES] = ent.view(np.uint8).reshape(-1)[: m * EDGE_ENTRY_BYTES]
        return CustomCSR(pointer_data=pbuf, graph_data=gbuf, n=n, m=m)

    def decode(self) -> CSRGraph:
        n, m = self.n, self.m
        row = np.zeros(n + 1, np.int64)
        col = np.zeros(m, np.int32)
        val = np.zeros(m, np.float32)
        for i in range(n):
            c, slot = divmod(i, PTRS_PER_CHUNK)
            off = c * CHUNK_BYTES + slot * PTR_ENTRY_BYTES
            e = self.pointer_data[off : off + PTR_ENTRY_BYTES].view(np.uint32)
            start = int(e[0]) * EDGES_PER_CHUNK + int(e[1])
            row[i] = start
            row[i + 1] = start + int(e[2])
        ent = self.graph_data[: m * EDGE_ENTRY_BYTES].view(np.uint32).reshape(m, 2)
        col[:] = ent[:, 0]
        val[:] = ent[:, 1].view(np.float32)
        return CSRGraph(row=row, col=col, val=val)

    @property
    def dram_bytes(self) -> int:
        return self.pointer_data.nbytes + self.graph_data.nbytes

    def read_requests_per_edge(self) -> float:
        """§5.11 model: 1/8 chunk per edge (8 edges/chunk) + 1 matching-bit
        chunk per edge worst-case = 1.125 requests/edge."""
        return 1.0 + 1.0 / EDGES_PER_CHUNK
