"""Host address registry — the DNS/address analogue.

The reference allocates an IP per virtual host and keeps a hostname↔IP
registry queryable during the run (src/main/routing/address.c, dns.c). In
the tensor engines a host's "address" IS its dense host id (packets carry
src/dst ids), so the registry maps names ↔ ids ↔ topology vertices:

* each config host group ``name`` with count N owns hostnames
  ``name-0 .. name-(N-1)`` (and bare ``name`` = its first host, matching
  the config loader's ``@name`` references);
* ``resolve``/``reverse`` are O(1) dict/array lookups, usable at runtime
  by tools and model apps (apps address peers by id; the registry is how
  humans and analysis scripts name them).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Dns:
    names: list[str]          # canonical hostname per host id
    _by_name: dict[str, int]
    host_vertex: np.ndarray   # i32 [H]

    @classmethod
    def from_groups(cls, groups, host_vertex) -> "Dns":
        seen = [g.name for g in groups]
        assert len(set(seen)) == len(seen), (
            f"duplicate host group names: {sorted(set(n for n in seen if seen.count(n) > 1))}"
        )
        names: list[str] = []
        by_name: dict[str, int] = {}
        for g in groups:
            for i in range(g.count):
                hid = g.start + i
                name = f"{g.name}-{i}" if g.count > 1 else g.name
                names.append(name)
                by_name[name] = hid
            by_name.setdefault(g.name, g.start)  # bare group name = first
        return cls(names=names, _by_name=by_name,
                   host_vertex=np.asarray(host_vertex, np.int32))

    def resolve(self, name: str) -> int:
        """hostname → host id (KeyError on unknown, like NXDOMAIN)."""
        return self._by_name[name]

    def reverse(self, host_id: int) -> str:
        return self.names[host_id]

    def vertex_of(self, host_id: int) -> int:
        return int(self.host_vertex[host_id])

    def __len__(self) -> int:
        return len(self.names)
