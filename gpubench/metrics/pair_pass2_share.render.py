"""The share of the pair list's mesh-active rays that pass 1 leaves
unproven, so that pass 2 takes them: the port's counters ``pairs_unproven``
over ``pairs_mesh_active`` (slot 0, summed over the span stretch's calls).
None where the stretch counted no mesh-active ray."""


def read(run):
    sp = getattr(run, "spans", None)
    if sp is None:
        return None
    active = sum(sp.counters.get("pairs_mesh_active", []))
    if not active:
        return None
    return sum(sp.counters.get("pairs_unproven", [])) / active
