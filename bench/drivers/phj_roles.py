"""Clients that submit joins of a primary-key relation P and a
foreign-key relation F to one ``JoinQueryService``, either one built.

The configuration gives the relations by role (``data.primary``,
``data.foreign``: rows and key spec, see ``bench.data.relations``) and
the traffic names the one built (``"build": "primary"`` or
``"foreign"``); the other is probed.  Each relation is drawn from a
stream named after its role, so for one seed the cells of one
configuration join the same relations, in their own orientation; Zipf
keys come from ``bench.data.zipf_keys``, which remakes them bit for bit
on the card, as the check needs.  Everything else (clients, pool,
warm-up, window, check) is ``phj_service``'s.

The control (``compared(control=True)``) answers each kept query with
``bench.reference.unique_join``: the join that takes the keys to be
unique on both sides, one pair per shared key.
"""
from __future__ import annotations

from ..data.zipf_keys import make_relation_exact
from ..reference.unique_join import unique_key_pairs
from . import phj_service

ROLES = ("primary", "foreign")


def _cut(spec: dict, rows: int) -> dict:
    """``spec`` at ``rows`` tuples, its key range (where it has one)
    cut alike."""
    keys = dict(spec["keys"])
    if "range" in keys:
        keys["range"] = rows
    return {**spec, "rows": rows, "keys": keys}


class Driver(phj_service.Driver):
    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 log=lambda *a: None):
        built = traffic["build"]
        if built not in ROLES:
            raise ValueError(f"traffic builds {built!r}, not one of {ROLES}")
        self.roles = (built, ROLES[1 - ROLES.index(built)])
        data = config["data"]
        specs = [data[role] for role in self.roles]
        # bench/tests/_tiny.shrink cuts a configuration without data.build
        # as SSB's, writing SSB's table sizes under data.rows: both
        # relations then take the fact table's size.
        rows = data.get("rows")
        if isinstance(rows, dict):
            specs = [_cut(spec, int(rows["lineorder"])) for spec in specs]
        super().__init__({**config, "data": dict(zip(("build", "probe"),
                                                     specs))},
                         traffic, seed, device, log=log)

    def _tensors(self, stream):
        return tuple(make_relation_exact(spec, self.device, self.seed,
                                         *stream, role)
                     for spec, role in zip((self.build_spec,
                                            self.probe_spec), self.roles))

    def compared(self, queries: list, control: bool = False) -> dict:
        """``phj_service.Driver.compared``; with ``control`` the kept
        answers are first replaced by the control's, one per query."""
        if control:
            made: dict = {}
            for index in sorted(self.kept, key=self._stream):
                stream = self._stream(index)
                if stream not in made:      # pool slots recur
                    (br, bk), (pr, pk) = self._tensors(stream)
                    made = {stream: unique_key_pairs(br, bk, pr, pk)}
                self.kept[index] = made[stream]
        return super().compared(queries)
