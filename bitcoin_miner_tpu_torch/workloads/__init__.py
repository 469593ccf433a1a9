"""The workload registry of the port: range-fold workloads by name.

Counterpart of ``bitcoin_miner_tpu/workloads``, with the same names, golden
vectors and state envelopes, and the port's tier vocabulary (``cuda``,
``torch``, ``cpu``, ``hashlib``).  The miner resolves its workload here
(``--workload NAME``, env ``BMT_WORKLOAD``) and builds its search, and its
watchdog chain, from the workload's tier ladder.

Registered workloads:

- ``sha256d`` — the frozen default: SHA-256 over ``"<data> <nonce>"``,
  first 8 digest bytes big-endian (reference ``bitcoin/hash.go:13-17``);
  the native C++ sweep computes it.
- ``preimage`` — SHA-256 over ``"<data>:<nonce>"``; the same template
  family, so it takes the SHA-256 kernels through the layout's separator.
- ``blake2b64`` — BLAKE2b-64 over ``"<data> <nonce>"``: the second kernel
  family (``csrc/blake2b_minhash.cu``, ``ops/blake2b.py``).

One workload per process: the wire protocol stays the frozen ``(data,
lower, upper)`` triple, so a server and its miners agree on the workload
out of band.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Union

from .base import TIER_LADDER, GoldenVector, Workload  # noqa: F401
from .blake2b import Blake2bWorkload
from .sha256 import Sha256Workload

#: The default every consumer uses when no workload is named.
DEFAULT_WORKLOAD = "sha256d"

#: Env spelling of ``--workload``.
WORKLOAD_ENV = "BMT_WORKLOAD"

_REGISTRY: Dict[str, Workload] = {}


def register(workload: Workload) -> Workload:
    """Add a workload to the registry (at import; names are final)."""
    if not workload.name:
        raise ValueError("workload has no name")
    if workload.name in _REGISTRY:
        raise ValueError(f"workload {workload.name!r} already registered")
    if not workload.golden:
        raise ValueError(
            f"workload {workload.name!r} has no golden vectors — every "
            "registered workload must pin its hash function in source"
        )
    if not workload.tiers or workload.tiers[-1] != "hashlib":
        raise ValueError(
            f"workload {workload.name!r} tier ladder must end at the "
            "un-wedgeable 'hashlib' oracle tier"
        )
    unknown = [t for t in workload.tiers if t not in TIER_LADDER]
    if unknown:
        raise ValueError(f"workload {workload.name!r} names unknown tiers {unknown}")
    if workload.native_ok:
        # The sweeps trust native_ok blindly (host folds and the cpu
        # tier go through the compiled default-format sweep), so the
        # workload's oracle must be the default family.
        from ..bitcoin.hash import hash_nonce as _default_hash

        for probe_data, probe_nonce in (("native-ok", 0), ("", 987654321)):
            if workload.hash_nonce(probe_data, probe_nonce) != _default_hash(
                probe_data, probe_nonce
            ):
                raise ValueError(
                    f"workload {workload.name!r} sets native_ok but its "
                    "hash_nonce disagrees with the default family the "
                    "native sweep computes"
                )
    _REGISTRY[workload.name] = workload
    return workload


def names() -> List[str]:
    """Registered workload names, default first then sorted."""
    rest = sorted(n for n in _REGISTRY if n != DEFAULT_WORKLOAD)
    return [DEFAULT_WORKLOAD, *rest] if DEFAULT_WORKLOAD in _REGISTRY else rest


def get(name: str) -> Workload:
    """The workload registered under ``name``; raises ValueError with the
    valid names for anything unknown."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown workload {name!r}; registered: {', '.join(names())}"
        ) from None


def resolve(workload: Union[Workload, str, None]) -> Workload:
    """Normalize a ``--workload`` value: None/"" -> the default, a name ->
    its registration, a Workload -> itself."""
    if workload is None or workload == "":
        return _REGISTRY[DEFAULT_WORKLOAD]
    if isinstance(workload, Workload):
        return workload
    return get(workload)


def resolve_nondefault(workload: Union[Workload, str, None]) -> Optional[Workload]:
    """:func:`resolve`, with None for the default: entry points pass this
    result through instead of deciding "is it the default?" themselves."""
    wl = resolve(workload)
    return None if wl.name == DEFAULT_WORKLOAD else wl


def stamp_state(payload: dict, workload_name: Optional[str]) -> dict:
    """The persistence envelope for per-workload state files: the default
    keeps the flat version-1 shape (plus the stamp); every other workload
    nests its payload under version 2, so a reader that checks no stamp
    finds nothing rather than another family's minima."""
    name = workload_name or DEFAULT_WORKLOAD
    if name == DEFAULT_WORKLOAD:
        return {"version": 1, "workload": name, **payload}
    return {"version": 2, "workload": name, "state": payload}


def unwrap_state(state: object, workload_name: Optional[str]) -> Optional[dict]:
    """Inverse of :func:`stamp_state`: the payload iff ``state`` carries
    ``workload_name``'s stamp, else None.  Unstamped flat files belong to
    the default."""
    if not isinstance(state, dict):
        return None
    name = workload_name or DEFAULT_WORKLOAD
    if state.get("workload", DEFAULT_WORKLOAD) != name:
        return None
    if state.get("version") == 2:
        payload = state.get("state")
        return payload if isinstance(payload, dict) else None
    return state


# --------------------------------------------------------------------------
# Registrations.  Golden vectors are frozen literals, the same as the
# reference package's.
# --------------------------------------------------------------------------

register(
    Sha256Workload(
        "sha256d",
        sep=" ",
        native_ok=True,
        description=(
            "frozen mining default: SHA-256('<data> <nonce>')[:8] "
            "big-endian (reference bitcoin/hash.go parity)"
        ),
        golden=(
            ("hello", 0, 13593802692011500125),
            ("hello", 12345, 6725106177369798965),
            ("bitcoin", 999999999999, 12216901194327863447),
            ("", 1, 16224919167884709661),
            ("chaos", 4000, 9384656945151152569),
        ),
    )
)

register(
    Sha256Workload(
        "preimage",
        sep=":",
        description=(
            "single-SHA-256 preimage/password search: "
            "SHA-256('<data>:<nonce>')[:8] big-endian"
        ),
        golden=(
            ("hello", 0, 5328521247272128883),
            ("hello", 12345, 11940169400677209234),
            ("bitcoin", 999999999999, 18080226961439275229),
            ("", 1, 9812795669417250081),
            ("chaos", 4000, 3383189675407663426),
        ),
    )
)

register(
    Blake2bWorkload(
        "blake2b64",
        description=(
            "BLAKE2b-64('<data> <nonce>') big-endian (alternative hash "
            "family; cuda kernel, torch plain version, host ladder)"
        ),
        golden=(
            ("hello", 0, 6710974778312606399),
            ("hello", 12345, 16732439934857232814),
            ("bitcoin", 999999999999, 8939386230447415819),
            ("", 1, 18227269363522651860),
            ("chaos", 4000, 4912459025450228006),
        ),
    )
)

__all__ = [
    "DEFAULT_WORKLOAD",
    "WORKLOAD_ENV",
    "Workload",
    "Sha256Workload",
    "Blake2bWorkload",
    "TIER_LADDER",
    "GoldenVector",
    "register",
    "names",
    "get",
    "resolve",
    "resolve_nondefault",
    "stamp_state",
    "unwrap_state",
]
