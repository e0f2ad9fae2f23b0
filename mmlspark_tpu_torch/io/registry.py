"""Versioned model registry: the durable store behind zero-downtime
rollout.  The port's copy of ``mmlspark_tpu/io/registry.py``; a port
registry and a reference registry read each other's roots, since the
files, the manifest and the digests are the same bytes.

The serving stack can hot-swap a booster in memory
(``CompiledPredictor`` + ``Booster.invalidate_cache()``); this module
records *which* model is in production, so that a restart serves the
same one, a torn write is refused, and a rollback names a version.  It
is the registry the :class:`~mmlspark_tpu_torch.io.rollout.RolloutController`
promotes and rolls back against:

* **Monotonic versions** — :meth:`ModelRegistry.publish` assigns the
  next integer version and never reuses one; entries are immutable
  (state transitions aside) so "version 7" always names the same bytes.
* **Durable writes** — the model file is written tmp + fsync + atomic
  rename, then the manifest is replaced the same way and the directory
  fsync'd (the write→rename→dirfsync discipline of the training
  checkpoints): a SIGKILL or power cut at ANY instant leaves either the
  old manifest or the new one, both complete — never a half-updated
  registry.  The manifest replace is the single commit point; a model
  file the manifest doesn't name yet is invisible garbage, not a torn
  entry.
* **Content digests** — every entry records the sha256 of its model
  text; :meth:`load` re-hashes the file on EVERY load and refuses a
  mismatch with :class:`ModelCorruption`, quarantining the entry so the
  rollout gate can never promote it.  (The model file itself also
  carries the ``Booster.save_native_model`` digest header — two
  independent detectors for bit rot.)
* **Promotion states** — ``candidate → active → retired`` with
  ``rolled_back`` and ``quarantined`` terminal states; exactly one
  entry is ``active`` at a time and :meth:`activate` refuses
  quarantined entries.  The manifest records the active version, so a
  restarted server resolves "what do I serve" from ONE fsync'd file.
* **An explicit device** — :meth:`ModelRegistry.load` builds the booster
  on the device its caller names (``"cuda"`` by default, as every entry
  point of the port): the rollout, the refresh controller and the drills
  pass theirs, and a CPU user asks for ``"cpu"``.

Layout (all under the registry root)::

    manifest.json            # atomic-replaced commit point
    models/v000007.txt       # immutable native-model text per version

The registry is process-local with a lock for thread safety; the
multi-writer case (several drivers publishing concurrently) is out of
scope — production deployments run one publisher (the training loop)
per registry root, like one writer per checkpoint dir.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ..device import DeviceLike

log = logging.getLogger(__name__)

__all__ = ["ModelCorruption", "ModelRegistry", "RegistryError"]

_MANIFEST = "manifest.json"
_MODELS_DIR = "models"
_FORMAT = 1

#: entry lifecycle (docs/rollout.md §Gate state machine)
STATES = ("candidate", "active", "retired", "rolled_back", "quarantined")


class RegistryError(RuntimeError):
    """Registry contract violation (unknown version, illegal state
    transition, unreadable manifest)."""


class ModelCorruption(RegistryError):
    """A model file's bytes no longer hash to the digest recorded at
    publish time (bit rot, torn write, tampering).  The entry is
    quarantined; the caller must fall back to a healthy version."""


def _fsync_dir(path: str) -> None:
    """fsync a directory so a just-renamed file survives power loss
    (same rationale as the checkpoint writer's)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _atomic_write(path: str, data: bytes) -> None:
    """tmp + fsync + atomic rename + directory fsync."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        fh.write(data)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(path) or ".")


def sha256_hex(data) -> str:
    if isinstance(data, str):
        data = data.encode("utf-8")
    return hashlib.sha256(data).hexdigest()


class ModelRegistry:
    """Durable, versioned store of native-model strings.

    ``pre_commit_hook`` is a chaos/test seam: called immediately BEFORE
    each manifest replace (the commit point), so a drill can SIGKILL
    the process mid-cutover and prove recovery lands on one consistent
    version (tools/chaos_rollout.py scenario C).
    """

    def __init__(self, root: str, *,
                 pre_commit_hook: Optional[Callable[[], None]] = None):
        self.root = os.path.abspath(root)
        self._models = os.path.join(self.root, _MODELS_DIR)
        os.makedirs(self._models, exist_ok=True)
        self._lock = threading.RLock()
        self.pre_commit_hook = pre_commit_hook
        self._manifest = self._read_manifest()

    # -- manifest ------------------------------------------------------------

    def _manifest_path(self) -> str:
        return os.path.join(self.root, _MANIFEST)

    def _read_manifest(self) -> Dict[str, Any]:
        path = self._manifest_path()
        # a stale .tmp from a crash mid-atomic-write is garbage by
        # contract (the rename never landed); ignore it
        if not os.path.exists(path):
            return {"format": _FORMAT, "next_version": 1,
                    "active": None, "entries": {}}
        try:
            with open(path, "rb") as fh:
                m = json.loads(fh.read().decode("utf-8"))
        except (OSError, ValueError) as e:
            # the manifest is replaced atomically, so an unparsable one
            # means external damage, not a torn write — refuse loudly
            # instead of silently re-initialising over real entries
            raise RegistryError(
                f"unreadable registry manifest {path}: {e}") from e
        if m.get("format") != _FORMAT:
            raise RegistryError(
                f"registry manifest format {m.get('format')!r} not "
                f"supported (want {_FORMAT})")
        return m

    def _commit(self) -> None:
        """Replace the manifest atomically — THE commit point."""
        if self.pre_commit_hook is not None:
            self.pre_commit_hook()
        data = json.dumps(self._manifest, indent=1,
                          sort_keys=True).encode("utf-8")
        _atomic_write(self._manifest_path(), data)

    def reload(self) -> None:
        """Re-read the manifest from disk, picking up commits made by
        OTHER processes sharing the registry root — e.g. a refresh
        trainer publishing a candidate while this process serves.  The
        manifest replace is atomic, so a reload sees either the old or
        the new state, never a torn one."""
        with self._lock:
            self._manifest = self._read_manifest()

    # -- queries -------------------------------------------------------------

    def entries(self) -> Dict[int, Dict[str, Any]]:
        with self._lock:
            return {int(v): dict(e)
                    for v, e in self._manifest["entries"].items()}

    def entry(self, version: int) -> Dict[str, Any]:
        with self._lock:
            e = self._manifest["entries"].get(str(int(version)))
            if e is None:
                raise RegistryError(
                    f"registry has no version {version}")
            return dict(e)

    def active_version(self) -> Optional[int]:
        with self._lock:
            a = self._manifest.get("active")
            return None if a is None else int(a)

    def latest_version(self) -> Optional[int]:
        with self._lock:
            vs = [int(v) for v in self._manifest["entries"]]
            return max(vs) if vs else None

    def candidates(self) -> List[int]:
        """Versions still awaiting a promotion decision, oldest first."""
        with self._lock:
            return sorted(
                int(v) for v, e in self._manifest["entries"].items()
                if e.get("promoted_state") == "candidate")

    def model_path(self, version: int) -> str:
        return os.path.join(self._models, f"v{int(version):06d}.txt")

    def profile_path(self, version: int) -> str:
        """The version's fit-time reference-profile file —
        lives beside the model file, written and verified with the
        identical tmp+fsync+rename+digest discipline."""
        return os.path.join(self._models,
                            f"v{int(version):06d}.profile.json")

    # -- writes --------------------------------------------------------------

    def publish(self, model, *, activate: bool = False,
                meta: Optional[Dict[str, Any]] = None,
                profile=None) -> int:
        """Store a model (a :class:`~mmlspark_tpu_torch.gbdt.booster.Booster`
        or a native-model text string) as the next version.  The model
        file becomes durable BEFORE the manifest names it; a crash
        between the two leaves an invisible orphan file, never a
        dangling entry.  ``activate=True`` additionally promotes the
        new entry in the same manifest commit (the bootstrap path — a
        canaried rollout publishes a candidate and lets the gate
        promote it).

        ``profile``: the fit-time
        :class:`~mmlspark_tpu_torch.core.sketch.ReferenceProfile` (or its
        JSON text) persisted beside the model under the same
        digest-verified atomic-rename discipline; defaults to the
        booster's own ``reference_profile`` when the engine captured
        one.  The profile file becomes durable before the manifest
        names it, exactly like the model file."""
        text = model if isinstance(model, str) \
            else model.save_native_model_string()
        if not text:
            raise RegistryError("refusing to publish an empty model")
        if profile is None:
            profile = getattr(model, "reference_profile", None)
        profile_text = None
        if profile is not None:
            profile_text = profile if isinstance(profile, str) \
                else profile.to_json()
        # embed the booster-level digest header too, so the file is
        # self-verifying even when read outside the registry
        from ..gbdt.booster import with_digest_header
        payload = with_digest_header(text).encode("utf-8")
        digest = sha256_hex(payload)
        with self._lock:
            version = int(self._manifest["next_version"])
            path = self.model_path(version)
            _atomic_write(path, payload)
            entry = {
                "version": version,
                "digest": f"sha256:{digest}",
                "created": time.time(),
                "promoted_state": "candidate",
                "size_bytes": len(payload),
            }
            if profile_text is not None:
                pbytes = profile_text.encode("utf-8")
                _atomic_write(self.profile_path(version), pbytes)
                entry["profile_digest"] = \
                    f"sha256:{sha256_hex(pbytes)}"
            if meta:
                entry["meta"] = dict(meta)
            self._manifest["entries"][str(version)] = entry
            self._manifest["next_version"] = version + 1
            if activate:
                self._activate_locked(version)
            self._commit()
            return version

    def _activate_locked(self, version: int) -> None:
        e = self._manifest["entries"].get(str(int(version)))
        if e is None:
            raise RegistryError(f"registry has no version {version}")
        if e["promoted_state"] == "quarantined":
            raise RegistryError(
                f"version {version} is quarantined (digest mismatch); "
                "refusing to activate")
        old = self._manifest.get("active")
        if old is not None and int(old) != int(version):
            old_e = self._manifest["entries"].get(str(int(old)))
            if old_e is not None \
                    and old_e["promoted_state"] == "active":
                old_e["promoted_state"] = "retired"
        e["promoted_state"] = "active"
        e["promoted_at"] = time.time()
        self._manifest["active"] = int(version)

    def activate(self, version: int) -> int:
        """Promote ``version`` to active (the previous active entry
        retires) in one atomic manifest commit."""
        with self._lock:
            self._activate_locked(int(version))
            self._commit()
            return int(version)

    def mark(self, version: int, state: str) -> None:
        """Record a state transition (``rolled_back`` after a failed
        canary, ``quarantined`` after a digest mismatch).  Demoting the
        active entry clears the active pointer.  ``quarantined`` is
        terminal: it records proven on-disk corruption, and overwriting
        it (e.g. with ``rolled_back``) would make the entry eligible
        for re-activation — transitions out of it raise instead."""
        if state not in STATES:
            raise RegistryError(f"unknown promoted_state {state!r}")
        with self._lock:
            e = self._manifest["entries"].get(str(int(version)))
            if e is None:
                raise RegistryError(
                    f"registry has no version {version}")
            if e["promoted_state"] == "quarantined":
                if state == "quarantined":
                    return          # idempotent re-quarantine
                raise RegistryError(
                    f"version {version} is quarantined (digest "
                    f"mismatch); refusing to mark it {state!r}")
            e["promoted_state"] = state
            if self._manifest.get("active") == int(version) \
                    and state != "active":
                self._manifest["active"] = None
            self._commit()

    def quarantine(self, version: int) -> None:
        self.mark(int(version), "quarantined")

    def rollback(self, to_version: Optional[int] = None) -> int:
        """Demote the active entry to ``rolled_back`` and re-activate
        ``to_version`` (default: the newest retired entry — the model
        that was serving before the bad promote)."""
        with self._lock:
            cur = self._manifest.get("active")
            if to_version is None:
                retired = sorted(
                    (int(v) for v, e in
                     self._manifest["entries"].items()
                     if e.get("promoted_state") == "retired"),
                    reverse=True)
                if not retired:
                    raise RegistryError(
                        "no retired version to roll back to")
                to_version = retired[0]
            if cur is not None:
                ce = self._manifest["entries"].get(str(int(cur)))
                if ce is not None:
                    ce["promoted_state"] = "rolled_back"
                self._manifest["active"] = None
            self._activate_locked(int(to_version))
            self._commit()
            return int(to_version)

    def prune(self, keep_last: int = 5) -> List[int]:
        """Registry retention/GC: delete the model +
        profile files of ``retired``/``rolled_back`` entries beyond the
        newest ``keep_last`` of them.  An auto-refreshing loop
        publishes a new version per drift episode, so without GC
        ``models/`` grows until the disk fills.

        Atomicity keeps the manifest-as-commit-point invariant:
        entries leave the manifest FIRST (one atomic replace), files
        are unlinked after — a crash between the two leaves orphan
        files the manifest no longer names (invisible garbage, exactly
        like a crash mid-:meth:`publish`), never a manifest entry whose
        bytes are gone.  ``quarantined`` entries are never pruned:
        they are the forensic evidence of proven corruption.  Active
        and candidate entries are untouched by construction.  Returns
        the pruned versions, oldest first."""
        if keep_last < 0:
            raise RegistryError(
                f"prune keep_last must be >= 0, got {keep_last}")
        with self._lock:
            prunable = sorted(
                int(v) for v, e in self._manifest["entries"].items()
                if e.get("promoted_state") in ("retired", "rolled_back"))
            victims = prunable[:max(0, len(prunable) - int(keep_last))]
            if not victims:
                return []
            paths = []
            for v in victims:
                del self._manifest["entries"][str(v)]
                paths.append(self.model_path(v))
                paths.append(self.profile_path(v))
            self._commit()
        for p in paths:
            try:
                os.unlink(p)
            except FileNotFoundError:
                pass        # profile-less entry, or a re-run after a
                            # crash between commit and unlink
        _fsync_dir(self._models)
        log.info("registry pruned %d version(s): %s",
                 len(victims), victims)
        return victims

    # -- loads ---------------------------------------------------------------

    def verify(self, version: int) -> bool:
        """Re-hash ``version``'s file against its recorded digest."""
        e = self.entry(version)
        path = self.model_path(version)
        try:
            with open(path, "rb") as fh:
                data = fh.read()
        except OSError:
            return False
        want = e["digest"].split(":", 1)[-1]
        return sha256_hex(data) == want

    def read_text(self, version: int) -> str:
        """The version's model text, digest-verified.  A mismatch
        quarantines the entry (one atomic manifest commit) and raises
        :class:`ModelCorruption` — a torn or bit-flipped model file is
        REJECTED at load, never served.  An :class:`OSError` (EMFILE,
        an NFS blip, a permission hiccup) raises WITHOUT a state
        transition: only the bytes themselves hashing wrong proves
        corruption, and a transient read failure must not permanently
        strand a healthy version in quarantine."""
        e = self.entry(version)
        path = self.model_path(version)
        try:
            with open(path, "rb") as fh:
                data = fh.read()
        except OSError as ex:
            raise RegistryError(
                f"model file for version {version} unreadable: "
                f"{ex}") from ex
        want = e["digest"].split(":", 1)[-1]
        got = sha256_hex(data)
        if got != want:
            self.quarantine(version)
            raise ModelCorruption(
                f"model file for version {version} fails its digest "
                f"(want sha256:{want[:12]}…, got sha256:{got[:12]}…); "
                "entry quarantined")
        return data.decode("utf-8")

    def load_profile(self, version: int):
        """The version's fit-time
        :class:`~mmlspark_tpu_torch.core.sketch.ReferenceProfile`,
        digest-verified, or ``None`` with a warning for entries that
        never recorded one (digest-less legacy publishes, fits with
        capture disabled) — drift monitoring is simply off for that
        version, never an error.  A recorded digest that no longer
        matches the bytes is the SAME corruption contract the model
        file has: the entry is quarantined and
        :class:`ModelCorruption` raises; a transient read failure
        raises :class:`RegistryError` without a state transition."""
        e = self.entry(int(version))
        want = e.get("profile_digest")
        if want is None:
            log.warning(
                "registry version %s has no reference profile "
                "(legacy/profile-less entry); drift monitoring is off "
                "for this version", version)
            return None
        path = self.profile_path(int(version))
        try:
            with open(path, "rb") as fh:
                data = fh.read()
        except OSError as ex:
            raise RegistryError(
                f"reference profile for version {version} unreadable: "
                f"{ex}") from ex
        got = sha256_hex(data)
        if got != want.split(":", 1)[-1]:
            self.quarantine(int(version))
            raise ModelCorruption(
                f"reference profile for version {version} fails its "
                f"digest (want {want[:19]}…, got sha256:{got[:12]}…); "
                "entry quarantined")
        from ..core.sketch import ReferenceProfile
        return ReferenceProfile.from_json(data.decode("utf-8"))

    def load(self, version: Optional[int] = None, *,
             device: DeviceLike = "cuda"):
        """Load a :class:`~mmlspark_tpu_torch.gbdt.booster.Booster` on
        ``device`` (``version=None`` loads the active entry).  Both
        digests — the registry's and the file's embedded header — are
        verified, and the version's reference profile (when recorded) is
        attached as ``booster.reference_profile`` so a drift monitor can
        be built straight off the loaded model."""
        from ..gbdt.booster import Booster
        if version is None:
            version = self.active_version()
            if version is None:
                raise RegistryError("registry has no active version")
        text = self.read_text(int(version))
        booster = Booster.load_native_model_string(text, device=device)
        booster.reference_profile = self.load_profile(int(version))
        return booster
