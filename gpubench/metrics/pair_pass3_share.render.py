"""The share of the pair list's mesh-active rays that pass 3 (the
exhaustive walk) takes: the port's counters ``pairs_walk_rays`` over
``pairs_mesh_active`` (slot 0, summed over the span stretch's calls). None
where the stretch counted no mesh-active ray."""


def read(run):
    sp = getattr(run, "spans", None)
    if sp is None:
        return None
    active = sum(sp.counters.get("pairs_mesh_active", []))
    if not active:
        return None
    return sum(sp.counters.get("pairs_walk_rays", [])) / active
