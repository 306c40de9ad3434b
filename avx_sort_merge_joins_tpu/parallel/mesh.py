"""Device-mesh construction and exchange-scheduling strategies.

The replacement for the reference's CPU/NUMA topology layer (reference:
src/util/cpu_mapping.c — logical→physical thread maps, NUMA region
queries) and its NUMA shuffle strategies (reference:
src/util/numa_shuffle.c:55-85).  Threads become mesh devices; "NUMA
region" becomes the host a device belongs to; the shuffle order becomes
the schedule of collective-permute rounds of the sorted-run exchange.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..types import NumaStrategy

AXIS = "chips"
HOST_AXIS = "host"

# Set by the CLI's --mapping-file (the cpu-mapping.txt analog): when not
# None, make_mesh() draws devices from this mesh's custom order instead of
# jax.devices() order (cpu_mapping.c:46-80 custom topology vs :178-193
# identity default).
DEFAULT_MESH: Optional[Mesh] = None


# Host (NUMA-region) granularity of the flat device list — the "threads
# per region" structure the reference derives from libnuma
# (cpu_mapping.c:281-316) and feeds into the RING shuffle.  Module state
# like the reference's global cpu-mapping tables (Mesh objects are
# interned/immutable, so per-mesh tagging is impossible).
HOST_GRANULARITY: Optional[int] = None


def make_mesh(n_devices: Optional[int] = None, devices=None,
              chips_per_host: Optional[int] = None) -> Mesh:
    """1-D mesh over the first ``n_devices`` available devices — the analog
    of cpu_mapping_init's identity thread map (cpu_mapping.c:178-193).
    A mapping-file mesh installed in DEFAULT_MESH overrides device order;
    ``chips_per_host`` installs the topology's host granularity."""
    global HOST_GRANULARITY
    if devices is None:
        if DEFAULT_MESH is not None:
            devices = list(np.asarray(DEFAULT_MESH.devices).flat)
        else:
            devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    if chips_per_host is not None:
        HOST_GRANULARITY = chips_per_host
    return Mesh(np.asarray(devices), (AXIS,))


def make_mesh2d(n_hosts: int, chips_per_host: int, devices=None) -> Mesh:
    """2-D ('host', 'chip') mesh — the hierarchical topology the reference
    derives from libnuma (regions × threads-per-region,
    cpu_mapping.c:281-316).  Collectives over the 'chip' axis stay within
    a host; collectives over 'host' cross hosts.  The flat
    device rank of (h, c) is h*chips_per_host + c, matching the 1-D mesh's
    order so shard layouts are interchangeable."""
    if devices is None:
        if DEFAULT_MESH is not None:
            devices = list(np.asarray(DEFAULT_MESH.devices).flat)
        else:
            devices = jax.devices()
    n = n_hosts * chips_per_host
    assert len(devices) >= n, (
        f"mesh2d wants {n} devices, {len(devices)} available")
    arr = np.asarray(devices[:n]).reshape(n_hosts, chips_per_host)
    return Mesh(arr, (HOST_AXIS, AXIS))


def is_2d(mesh: Mesh) -> bool:
    return len(mesh.axis_names) == 2


def flat_axes(mesh: Mesh):
    """The collective axis spec addressing ALL devices of the mesh as one
    flat rank space: the axis-name tuple for 2-D meshes, the single axis
    name for 1-D."""
    names = tuple(mesh.axis_names)
    return names if len(names) > 1 else names[0]


def flat_spec(mesh: Mesh) -> P:
    """PartitionSpec sharding a leading axis over every mesh axis in order
    (flat rank h*C + c on 2-D meshes)."""
    return P(tuple(mesh.axis_names))


def host_shape(mesh: Mesh):
    """(n_hosts, chips_per_host) of the mesh: the real axes of a 2-D mesh,
    or (1, n) for a flat mesh."""
    if is_2d(mesh):
        return (mesh.shape[HOST_AXIS], mesh.shape[AXIS])
    return (1, int(np.prod(list(mesh.shape.values()))))


def chips_per_host_of(mesh: Mesh) -> int:
    """Host granularity for shuffle scheduling: a 2-D mesh's own chip
    axis, else the installed topology (mapping file / make_mesh kw) or,
    failing that, the per-host device count from the platform's process
    mapping."""
    if is_2d(mesh):
        return mesh.shape[AXIS]
    if HOST_GRANULARITY is not None:
        return HOST_GRANULARITY
    devices = list(np.asarray(mesh.devices).flat)
    procs = [getattr(d, "process_index", 0) for d in devices]
    return max(1, procs.count(procs[0])) if procs else 1


def mesh_from_mapping_file(path: str) -> Mesh:
    """Build a mesh from a device-mapping file — the analog of the
    reference's optional ``cpu-mapping.txt`` custom topology (format
    ``NDEV id0 id1 ... idN [#HOSTS]``, cpu_mapping.h:24-25,
    cpu_mapping.c:46-80; the optional trailing count mirrors the
    reference's ``#numa`` annotation and installs the host granularity):
    logical position i runs on physical device ids[i]."""
    global HOST_GRANULARITY
    with open(path) as f:
        tokens = f.read().split()
    n = int(tokens[0])
    ids = [int(t) for t in tokens[1:1 + n]]
    if len(tokens) > 1 + n:
        HOST_GRANULARITY = max(1, n // max(1, int(tokens[1 + n])))
    devices = jax.devices()
    return Mesh(np.asarray([devices[i] for i in ids]), (AXIS,))


def sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading axis over the mesh (per-chip shard = the reference's
    NUMA-local chunk, generator.c:352-404)."""
    return NamedSharding(mesh, P(AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shuffle_order(strategy: str, n: int, chips_per_host: int = 4,
                  seed: int = 12345) -> np.ndarray:
    """Visit order offsets for the exchange rounds: round i of device ``d``
    touches partner ``(d + order[i]) % n``.

    Mirrors the reference strategies (numa_shuffle.c:55-85):
      NEXT   — neighbours first: offsets 0,1,2,…  (get_numa_shuffle_strategy
               NEXT, numa_shuffle.c:83),
      RING   — stride by the chips-per-host count so consecutive rounds hit
               different hosts (numa_shuffle.c:80),
      RANDOM — a seeded permutation (numa_shuffle.c:29-37,58-59).
    """
    if strategy == NumaStrategy.NEXT:
        return np.arange(n, dtype=np.int32)
    if strategy == NumaStrategy.RING:
        step = max(1, chips_per_host)
        offs = [(i * step + i // max(1, n // step)) % n for i in range(n)]
        # de-duplicate while preserving order; fill any gaps at the end
        seen, order = set(), []
        for o in offs:
            if o not in seen:
                seen.add(o)
                order.append(o)
        for o in range(n):
            if o not in seen:
                order.append(o)
        return np.asarray(order, dtype=np.int32)
    if strategy == NumaStrategy.RANDOM:
        rng = np.random.default_rng(seed)
        return rng.permutation(n).astype(np.int32)
    raise ValueError(f"unknown shuffle strategy {strategy!r}")
