"""Deterministic fault injection — the chaos harness behind QFEDX_FAULTS.

Counterpart of ``qfedx_tpu/utils/faults.py``, copied bit for bit (the
port imports nothing of the JAX package): the same ``SITES`` in the same
order, the same SplitMix64 coordinates, the same per-rule salts, so a
plan fires on the same clients, waves, attempts and requests in both
packages. A firing site bumps the reference's ``faults.injected.<site>``
obs counter (``faults.injected.serve.request`` for a mutated request).

Cross-device federation at QFed scale is DEFINED by partial
participation: clients die mid-round, local updates go non-finite,
registries and filesystems hiccup. The round machinery survives all
of these (fed/round survivor masks + quarantine, data/stream +
run/checkpoint retries) — this module makes those paths TESTABLE by
injecting the failures deterministically at the real seams instead of
hoping production reproduces them.

A ``FaultPlan`` is a seeded list of rules. Every decision is a pure
function of ``(seed, site, round, wave, client/attempt)`` via a
SplitMix64 hash — no RNG state, so a plan fires identically across
reruns, processes and resumes (the same counter-based-determinism
design as ``data.stream.SyntheticRegistry``).

Registered sites (the real seams; each consulted by the port's code,
``distributed.peer`` by a multi-process round's worker through
``dead_peers``):

- ``client.compute`` — per-(round, client) casualties, ``kind``:
  ``drop`` (client dies: it joins the round's survivor mask as 0, its
  weighted contribution and secure-agg masks vanish — fed/round),
  ``nan`` / ``inf`` (its local data is poisoned so its Δθ goes
  non-finite and the quarantine path must catch it organically).
- ``client.byzantine`` — per-(round, client) ADVERSARIES: the
  client completes local training, then tampers. ``kind``:
  ``scale:k`` multiplies its Δθ upload by k (the model-poisoning
  amplification attack), ``sign_flip`` negates it (= ``scale:-1`` but
  named for the taxonomy), ``noise`` (or ``noise:σ``, default σ=1)
  replaces it with σ·N(0, I), and ``label_flip`` flips its LABELS
  before training (binary 0/1 registries — y → 1−y) so the attack
  flows through real local gradients, not a synthetic delta. The first
  three reach the round program as a [cohort, 2] (multiplier, σ) input
  (``byzantine_multipliers``/``byzantine_noise`` → fed/round's attack
  variant); ``label_flip`` is applied by the WaveStream to the fetched
  batch (``label_flips``). The DEFENSE is ``FedConfig.aggregator``
  (clip_mean / trimmed_mean / median).
- ``client.slow`` — per-(round, client) STRAGGLERS: ``kind``
  ``slow:s`` (seconds; bare ``slow`` = 1 s) marks a client slow — the
  WaveStream uploader sleeps the wave's max slow-client seconds before
  fetching it, so a slow client holds up exactly its wave. Past the
  consumer's ``wave_deadline_s`` the wave goes late: a casualty under
  ``on_wave_error="drop"``, a buffered stale contribution under
  ``"buffer"`` (QFEDX_STALE).
- ``wave.delay`` — the same straggle injected per (round, wave):
  ``kind`` ``delay:s`` sleeps the whole wave's upload ``s`` seconds.
  The wave-granular dial the straggler bench/chaos tests drive
  (``rate`` draws the per-(round, wave) coin, like the error sites).
- ``registry.fetch`` — transient error raised inside the WaveStream
  uploader's fetch, before the registry is read (data/stream retries).
- ``ingest.h2d`` — same, between the host batch and the copy to the
  device.
- ``checkpoint.write`` — transient error in the async checkpoint
  writer's save attempt (run/checkpoint retries).
- ``distributed.peer`` — a peer process's in-flight client is declared
  dead: each process of a multi-process round calls
  ``check("distributed.peer", round, wave=peer)`` per peer
  (``dead_peers``; deterministic, so every process agrees with no
  communication) and folds the firing peers into the round's survivor
  mask (``tests/_torch_distributed_worker.py``'s dropout mode).
- ``serve.request`` — per-request corruption at the serving front door:
  ``kind`` ``nan`` (features go non-finite) / ``malformed`` (wrong
  feature shape). The micro-batcher mutates request #seq (the
  ``rounds`` coordinate is the request sequence) BEFORE validation, so
  the per-request 4xx rejection is exercised organically and a bad
  request can never poison its co-batched rows (serve/batcher.py).
- ``serve.compute`` — transient device error inside the serving
  engine's dispatch (the round coordinate is the batch sequence);
  retried under the shared seeded-jitter policy (serve/engine.py).

Rule spec (JSON or dict):

    {"seed": 7, "rules": [
      {"site": "client.compute", "kind": "drop", "clients": [3],
       "rounds": [1]},                       # exact casualty
      {"site": "client.compute", "kind": "nan", "rate": 0.05},
      {"site": "registry.fetch", "rate": 1.0, "rounds": [0],
       "times": 1}                           # fails attempt 0 only
    ]}

``rounds`` / ``waves`` restrict where a rule applies (absent = every-
where); ``clients`` lists exact registry ids, ``rate`` draws per-client
(client.compute) or per-(round, wave) (error sites) from the hash;
``times`` bounds how many retry ATTEMPTS an error site fails — the
transient/persistent dial (``times: 1`` + a 2-attempt retry = recovered,
``times`` absent = fails every attempt = persistent).

``QFEDX_FAULTS`` pins a plan process-wide: ``0``/``off`` (default) =
none, a ``{...}`` literal = inline JSON, anything else = path to a JSON
file. Read PER resolve (like QFEDX_TRACE) so tests flip it per run.
With no plan active every hook below is a no-op and the guarded round
program still runs — the faults-off bit-parity lever lives in
fed/round's QFEDX_GUARDS, not here.
"""

from __future__ import annotations

import json
import os
from functools import lru_cache
from pathlib import Path

import numpy as np

from qfedx_tpu_torch.utils import pins

SITES = (
    "client.compute",
    "registry.fetch",
    "ingest.h2d",
    "checkpoint.write",
    "distributed.peer",
    # Appended (not inserted): _site_code indexes this tuple, so the
    # hash coordinates of every earlier site — and therefore every
    # pinned plan draw — must not move.
    "client.byzantine",
    # Straggler sites (appended for the same reason).
    "client.slow",
    "wave.delay",
    # Serving sites (appended for the same reason).
    "serve.request",
    "serve.compute",
)
CLIENT_KINDS = ("drop", "nan", "inf")
# Byzantine base kinds; scale REQUIRES a parameter ("scale:100"), noise
# takes an optional σ ("noise" = σ 1.0, "noise:5" = σ 5).
BYZANTINE_KINDS = ("scale", "sign_flip", "noise", "label_flip")
# Straggler kinds: slow takes optional seconds ("slow" = 1 s,
# "slow:0.5"); delay REQUIRES them ("delay:0.5").
SLOW_KINDS = ("slow",)
# Serving request corruptions: the batcher MUTATES request #seq
# (nan = non-finite features, malformed = wrong feature shape) so the
# per-request rejection path is exercised through real validation — a
# mutation site like wave.delay, not an error site.
SERVE_REQUEST_KINDS = ("nan", "malformed")
_PER_CLIENT_SITES = ("client.compute", "client.byzantine", "client.slow")
# wave.delay returns a DURATION and serve.request returns a MUTATION
# (instead of raising), so check() rejects both — they are consulted
# through their own accessors, not the error-site path.
_ERROR_SITES = tuple(
    s for s in SITES
    if s not in _PER_CLIENT_SITES and s not in ("wave.delay", "serve.request")
)


def doc_taxonomy() -> dict[str, tuple[str, ...]]:
    """``{site: (kind spellings...)}`` — the canonical taxonomy the
    README's fault-site table mirrors row for row. Derived from the
    literal tuples above so a new site or kind cannot ship without a
    documentation row."""
    kinds = {
        "client.compute": CLIENT_KINDS,
        "client.byzantine": ("scale:k", "sign_flip", "noise", "label_flip"),
        "client.slow": ("slow:s",),
        "wave.delay": ("delay:s",),
        "serve.request": SERVE_REQUEST_KINDS,
    }
    return {s: kinds.get(s, ("error",)) for s in SITES}


class FaultInjected(RuntimeError):
    """A planned transient/persistent failure, raised at an error site.

    Typed so retry policies and tests can distinguish injected chaos
    from real failures; carries the site and the (round, wave, attempt)
    coordinate that fired.
    """

    def __init__(self, site: str, round_idx: int, wave: int, attempt: int):
        super().__init__(
            f"injected fault at {site} (round={round_idx}, wave={wave}, "
            f"attempt={attempt})"
        )
        self.site = site
        self.round_idx = round_idx
        self.wave = wave
        self.attempt = attempt


def _splitmix64(x: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):  # mod-2^64 wraparound IS the mixer
        x = (x + np.uint64(0x9E3779B97F4A7C15)).astype(np.uint64)
        x ^= x >> np.uint64(30)
        x *= np.uint64(0xBF58476D1CE4E5B9)
        x ^= x >> np.uint64(27)
        x *= np.uint64(0x94D049BB133111EB)
        x ^= x >> np.uint64(31)
    return x


def _site_code(site: str) -> np.uint64:
    return np.uint64(SITES.index(site) + 1)


def _uniform(seed: int, site: str, round_idx: int, wave, ids) -> np.ndarray:
    """[len(ids)] float64 in [0, 1), pure in every coordinate."""
    ids = np.asarray(ids, dtype=np.uint64)
    x = np.uint64(seed)
    for part in (_site_code(site), np.uint64(round_idx + 1),
                 np.uint64(int(wave) + 1)):
        x = _splitmix64(x ^ part)
    bits = _splitmix64(x ^ ids)
    return (bits >> np.uint64(11)) / float(1 << 53)


class _Rule:
    def __init__(self, spec: dict):
        unknown = set(spec) - {
            "site", "kind", "rate", "clients", "rounds", "waves", "times"
        }
        if unknown:
            raise ValueError(f"unknown fault-rule keys {sorted(unknown)}")
        self.site = spec.get("site")
        if self.site not in SITES:
            raise ValueError(
                f"fault rule site {self.site!r} not in {SITES}"
            )
        self.kind = spec.get("kind", "error")
        self.kind_param: float | None = None
        if self.site == "client.compute":
            if self.kind not in CLIENT_KINDS:
                raise ValueError(
                    f"client.compute kind {self.kind!r} not in {CLIENT_KINDS}"
                )
        elif self.site == "client.byzantine":
            # Parameterized kinds: "scale:100" / "noise:5"; the base
            # name keys the hash so two scale rules at different k
            # still fall independent coins per rule position.
            base, _, param = str(self.kind).partition(":")
            if base not in BYZANTINE_KINDS:
                raise ValueError(
                    f"client.byzantine kind {self.kind!r}: base must be "
                    f"one of {BYZANTINE_KINDS}"
                )
            if param:
                if base not in ("scale", "noise"):
                    raise ValueError(
                        f"kind {base!r} takes no parameter, got "
                        f"{self.kind!r}"
                    )
                self.kind_param = float(param)
            elif base == "scale":
                raise ValueError(
                    "kind 'scale' needs a multiplier, e.g. 'scale:100'"
                )
            elif base == "noise":
                self.kind_param = 1.0
            if base == "scale" and self.kind_param == 0:
                raise ValueError("scale:0 is a drop, not an attack — "
                                 "use client.compute kind='drop'")
            if base == "noise" and not self.kind_param > 0:
                raise ValueError(f"noise sigma must be > 0, got {self.kind!r}")
            self.kind = base
        elif self.site == "client.slow":
            base, _, param = str(self.kind).partition(":")
            if base != "slow":
                raise ValueError(
                    f"client.slow kind {self.kind!r}: expected 'slow' "
                    "or 'slow:seconds' (e.g. 'slow:0.5')"
                )
            self.kind_param = float(param) if param else 1.0
            if not self.kind_param > 0:
                raise ValueError(
                    f"slow seconds must be > 0, got {self.kind!r}"
                )
            self.kind = base
        elif self.site == "wave.delay":
            base, _, param = str(self.kind).partition(":")
            if base != "delay" or not param:
                raise ValueError(
                    f"wave.delay kind {self.kind!r}: needs "
                    "'delay:seconds' (e.g. 'delay:0.5')"
                )
            self.kind_param = float(param)
            if not self.kind_param > 0:
                raise ValueError(
                    f"delay seconds must be > 0, got {self.kind!r}"
                )
            self.kind = base
        elif self.site == "serve.request":
            if self.kind not in SERVE_REQUEST_KINDS:
                raise ValueError(
                    f"serve.request kind {self.kind!r} not in "
                    f"{SERVE_REQUEST_KINDS}"
                )
        elif self.kind != "error":
            raise ValueError(
                f"{self.site} supports only kind='error', got {self.kind!r}"
            )
        self.rate = spec.get("rate")
        self.clients = (
            None if spec.get("clients") is None
            else np.asarray(spec["clients"], dtype=np.int64)
        )
        if self.site == "wave.delay" and self.clients is not None:
            # Accepting-but-ignoring a clients list would be the
            # wrong-thing-measured error class the loud grammar exists
            # to prevent.
            raise ValueError(
                "wave.delay is per-(round, wave): restrict with "
                "'rounds'/'waves'/'rate', not 'clients' — "
                "client-granular straggle is the client.slow site"
            )
        if self.site == "client.slow" and spec.get("waves") is not None:
            # Per-client draws pin wave=0 (a client exists independent
            # of wave layout), so a 'waves' restriction would silently
            # never fire — same accept-but-ignore class as above.
            raise ValueError(
                "client.slow draws per (round, client): restrict with "
                "'rounds'/'clients'/'rate', not 'waves' — "
                "wave-granular straggle is the wave.delay site"
            )
        if (
            self.site in ("client.slow", "wave.delay")
            and spec.get("times") is not None
        ):
            raise ValueError(
                f"{self.site} injects a DURATION, not a retryable "
                "error — 'times' (the retry-attempt bound) does not "
                "apply"
            )
        if self.site == "serve.request":
            # Per-REQUEST mutation: the round coordinate is the request
            # sequence number; clients/waves/times have no meaning and
            # accepting-but-ignoring them would be the silent-no-fire
            # class the loud grammar exists to prevent.
            for bad in ("clients", "waves", "times"):
                if spec.get(bad) is not None:
                    raise ValueError(
                        f"serve.request draws per request sequence: "
                        f"restrict with 'rounds' (= request seqs) or "
                        f"'rate', not {bad!r}"
                    )
        if self.site in _PER_CLIENT_SITES:
            if (self.rate is None) == (self.clients is None):
                raise ValueError(
                    f"{self.site} rule needs exactly one of "
                    "'rate' or 'clients'"
                )
        elif self.rate is None:
            self.rate = 1.0
        if self.rate is not None and not (0.0 <= float(self.rate) <= 1.0):
            raise ValueError(f"rate must be in [0, 1], got {self.rate}")
        self.rounds = (
            None if spec.get("rounds") is None
            else {int(r) for r in spec["rounds"]}
        )
        self.waves = (
            None if spec.get("waves") is None
            else {int(w) for w in spec["waves"]}
        )
        self.times = (
            None if spec.get("times") is None else int(spec["times"])
        )
        if self.times is not None and self.times < 1:
            raise ValueError(f"times must be >= 1, got {self.times}")

    def applies(self, round_idx: int, wave) -> bool:
        if self.rounds is not None and int(round_idx) not in self.rounds:
            return False
        if self.waves is not None and int(wave) not in self.waves:
            return False
        return True


class FaultPlan:
    """A seeded, deterministic fault schedule (module docstring spec)."""

    def __init__(self, seed: int = 0, rules: list[dict] | None = None):
        self.seed = int(seed)
        self.rules = [_Rule(dict(r)) for r in (rules or [])]

    @classmethod
    def from_spec(cls, spec: dict) -> "FaultPlan":
        unknown = set(spec) - {"seed", "rules"}
        if unknown:
            raise ValueError(f"unknown fault-plan keys {sorted(unknown)}")
        return cls(seed=spec.get("seed", 0), rules=spec.get("rules"))

    @classmethod
    def from_json(cls, text_or_path: str | os.PathLike) -> "FaultPlan":
        text = str(text_or_path)
        if not text.lstrip().startswith("{"):
            text = Path(text).read_text()
        return cls.from_spec(json.loads(text))

    # -- per-client sites (client.compute / client.byzantine) ----------------

    def _rule_hits(self, site: str, kinds: tuple, kind: str,
                   round_idx: int, ids):
        """Yield ``(rule, hit_mask)`` per matching rule — the ONE
        definition of the per-client draw (parameterized byzantine
        kinds need the rule; plain sites OR the masks)."""
        ids = np.asarray(ids, dtype=np.int64)
        for idx, rule in enumerate(self.rules):
            if rule.site != site or rule.kind != kind:
                continue
            if not rule.applies(round_idx, 0):
                continue
            if rule.clients is not None:
                hit = np.isin(ids, rule.clients)
            else:
                # Hash salted by the RULE's position (like ``check``)
                # AND the kind index, so a drop rule and a nan rule at
                # the same rate — or two overlapping drop rules — fall
                # independent coin flips per client.
                u = _uniform(
                    self.seed + kinds.index(kind) + 7919 * (idx + 1),
                    site, round_idx, 0, ids,
                )
                hit = u < float(rule.rate)
            yield rule, hit

    def _site_hits(
        self, site: str, kinds: tuple, kind: str, round_idx: int, ids
    ) -> np.ndarray:
        hit = np.zeros(len(np.asarray(ids)), dtype=bool)
        for _rule, h in self._rule_hits(site, kinds, kind, round_idx, ids):
            hit |= h
        return hit

    def _client_hits(self, kind: str, round_idx: int, ids) -> np.ndarray:
        return self._site_hits(
            "client.compute", CLIENT_KINDS, kind, round_idx, ids
        )

    def _byz_hits(self, kind: str, round_idx: int, ids) -> np.ndarray:
        return self._site_hits(
            "client.byzantine", BYZANTINE_KINDS, kind, round_idx, ids
        )

    def survivors(self, round_idx: int, cohort_ids) -> np.ndarray:
        """[len(cohort_ids)] float32 0/1: 0 = this client DROPS this
        round (dies mid-round; fed/round zeroes its contribution and its
        secure-agg masks never reach the aggregate)."""
        return (~self._client_hits("drop", round_idx, cohort_ids)).astype(
            np.float32
        )

    def poison(self, round_idx: int, cohort_ids) -> np.ndarray:
        """[len(cohort_ids)] float32 multiplier injecting non-finite
        client data: 1 = clean, nan/inf where a ``nan``/``inf`` rule
        fires — multiplied into the client's features so its local
        update goes non-finite and the quarantine must catch it."""
        out = np.ones(len(np.asarray(cohort_ids)), dtype=np.float32)
        out[self._client_hits("nan", round_idx, cohort_ids)] = np.nan
        out[self._client_hits("inf", round_idx, cohort_ids)] = np.inf
        return out

    def casualty_counts(self, round_idx: int, cohort_ids) -> dict:
        """{"drop": n, "nan": n, "inf": n} — the EXACT per-round casualty
        ledger the chaos tests reconcile against metrics.jsonl."""
        return {
            k: int(self._client_hits(k, round_idx, cohort_ids).sum())
            for k in CLIENT_KINDS
        }

    # -- client.byzantine adversaries ----------------------------------------

    def _byz_rule_hits(self, kind: str, round_idx: int, ids):
        """``(rule, hit_mask)`` per matching byzantine rule —
        parameterized kinds (scale:k, noise:σ) need the RULE, not just
        the union; the draw itself is ``_rule_hits``, the one shared
        definition."""
        return self._rule_hits(
            "client.byzantine", BYZANTINE_KINDS, kind, round_idx, ids
        )

    def byzantine_multipliers(self, round_idx: int, cohort_ids) -> np.ndarray:
        """[len(cohort_ids)] float32 per-client Δθ multiplier: 1 =
        honest, k where a ``scale:k`` rule fires, negated where
        ``sign_flip`` fires (overlapping rules compose by product —
        a scaled sign-flipper uploads −k·Δθ)."""
        out = np.ones(len(np.asarray(cohort_ids)), dtype=np.float32)
        for rule, hit in self._byz_rule_hits("scale", round_idx, cohort_ids):
            out[hit] *= np.float32(rule.kind_param)
        for _rule, hit in self._byz_rule_hits(
            "sign_flip", round_idx, cohort_ids
        ):
            out[hit] *= np.float32(-1.0)
        return out

    def byzantine_noise(self, round_idx: int, cohort_ids) -> np.ndarray:
        """[len(cohort_ids)] float32 noise σ: 0 = honest; where a
        ``noise``/``noise:σ`` rule fires the client's upload is replaced
        by σ·N(0, I) (largest σ wins when rules overlap)."""
        out = np.zeros(len(np.asarray(cohort_ids)), dtype=np.float32)
        for rule, hit in self._byz_rule_hits("noise", round_idx, cohort_ids):
            out[hit] = np.maximum(out[hit], np.float32(rule.kind_param))
        return out

    def label_flips(self, round_idx: int, cohort_ids) -> np.ndarray:
        """[len(cohort_ids)] bool: clients whose LABELS flip before
        local training (data-level attack — flows through real
        gradients; binary-label registries, y → 1−y in data/stream)."""
        return self._byz_hits("label_flip", round_idx, cohort_ids)

    def byzantine_counts(self, round_idx: int, cohort_ids) -> dict:
        """{kind: n} per byzantine base kind — the exact per-round
        adversary ledger (the chaos tests reconcile ``clipped_clients``
        in metrics.jsonl against the update-level entries)."""
        return {
            k: int(self._byz_hits(k, round_idx, cohort_ids).sum())
            for k in BYZANTINE_KINDS
        }

    def byzantine_attack(self, round_idx: int, cohort_ids):
        """The round program's attack input: [cohort, 2] float32 of
        (multiplier, noise σ) — or None when every client is honest
        this round (the fast path: no attack program variant traces)."""
        mult = self.byzantine_multipliers(round_idx, cohort_ids)
        sigma = self.byzantine_noise(round_idx, cohort_ids)
        if np.all(mult == 1.0) and np.all(sigma == 0.0):
            return None
        return np.stack([mult, sigma], axis=1).astype(np.float32)

    # -- straggler sites (client.slow / wave.delay) --------------------------

    def slow_seconds(self, round_idx: int, cohort_ids) -> np.ndarray:
        """[len(cohort_ids)] float32 seconds: 0 = prompt client; where a
        ``slow``/``slow:s`` rule fires, the client is a STRAGGLER — the
        WaveStream delays its wave by the wave's max slow seconds
        (largest s wins when rules overlap)."""
        out = np.zeros(len(np.asarray(cohort_ids)), dtype=np.float32)
        for rule, hit in self._rule_hits(
            "client.slow", SLOW_KINDS, "slow", round_idx, cohort_ids
        ):
            out[hit] = np.maximum(out[hit], np.float32(rule.kind_param))
        return out

    def wave_delay_s(self, round_idx: int, wave: int) -> float:
        """Injected upload delay (seconds) for one (round, wave) from
        ``wave.delay`` rules — per-coordinate coin like ``check``'s,
        salted per rule position; largest firing delay wins."""
        delay = 0.0
        for idx, rule in enumerate(self.rules):
            if rule.site != "wave.delay" or not rule.applies(
                round_idx, wave
            ):
                continue
            u = _uniform(
                self.seed + 7919 * (idx + 1), "wave.delay", round_idx,
                wave, [0],
            )[0]
            if u < float(rule.rate):
                delay = max(delay, float(rule.kind_param))
        return delay

    def wave_delays(
        self, round_idx: int, cohort_ids, wave_size: int
    ) -> np.ndarray:
        """[num_waves] float32 seconds of injected straggle per wave:
        the max of the wave's ``wave.delay`` draw and its slowest
        ``client.slow`` member — the ONE number the WaveStream sleeps
        before fetching each wave, and the oracle the straggler chaos
        tests reconcile late-wave counts against."""
        ids = np.asarray(cohort_ids)
        wave_size = int(wave_size)
        num_waves = len(ids) // wave_size
        slow = self.slow_seconds(round_idx, ids)
        out = np.zeros(num_waves, dtype=np.float32)
        for w in range(num_waves):
            blk = slow[w * wave_size:(w + 1) * wave_size]
            out[w] = max(
                float(blk.max()) if len(blk) else 0.0,
                self.wave_delay_s(round_idx, w),
            )
        return out

    # -- serving sites --------------------------------------------------------

    def request_mutation(self, seq: int) -> str | None:
        """Mutation kind for serving request #``seq`` at the
        ``serve.request`` site — ``"nan"`` / ``"malformed"`` / None.
        The batcher applies the mutation BEFORE validation, so the
        per-request rejection (the 4xx path) is exercised through the
        same code real bad traffic hits. Per-coordinate coin like
        ``wave_delay_s``'s, salted per rule position; the first firing
        rule wins (rule order is the plan author's precedence)."""
        for idx, rule in enumerate(self.rules):
            if rule.site != "serve.request" or not rule.applies(seq, 0):
                continue
            u = _uniform(
                self.seed + 7919 * (idx + 1), "serve.request", seq, 0, [0]
            )[0]
            if u < float(rule.rate):
                from qfedx_tpu_torch import obs

                obs.counter("faults.injected.serve.request")
                return rule.kind
        return None

    # -- error sites ---------------------------------------------------------

    def check(
        self, site: str, round_idx: int, wave: int = 0, attempt: int = 0
    ) -> None:
        """Raise ``FaultInjected`` if a rule fires at this coordinate.

        Production seams call this with their retry ATTEMPT index: a
        rule with ``times: t`` fails attempts 0..t-1 and then lets the
        operation through — the transient-failure shape retries must
        recover from. No matching rule (or attempt ≥ times) = no-op.
        """
        if site not in _ERROR_SITES:
            raise ValueError(f"unknown error site {site!r}")
        for idx, rule in enumerate(self.rules):
            if rule.site != site or not rule.applies(round_idx, wave):
                continue
            if rule.times is not None and attempt >= rule.times:
                continue
            # Salt the hash with the RULE's position so two rate rules
            # on the same site fall independent coins (the same
            # independence _client_hits keys by kind).
            u = _uniform(
                self.seed + 7919 * (idx + 1), site, round_idx, wave, [0]
            )[0]
            if u < float(rule.rate):
                from qfedx_tpu_torch import obs

                obs.counter(f"faults.injected.{site}")
                raise FaultInjected(site, round_idx, wave, attempt)


    def dead_peers(self, round_idx: int, num_peers: int) -> list[int]:
        """The peers whose ``distributed.peer`` check fires in round
        ``round_idx``: ``check`` per peer (its ``wave`` coordinate), the
        ``FaultInjected`` caught."""
        dead = []
        for peer in range(num_peers):
            try:
                self.check("distributed.peer", round_idx, wave=peer)
            except FaultInjected:
                dead.append(peer)
        return dead


@lru_cache(maxsize=8)
def _inline_plan(value: str) -> FaultPlan:
    return FaultPlan.from_json(value)


def active_plan() -> FaultPlan | None:
    """The process-wide plan pinned by ``QFEDX_FAULTS`` (module
    docstring grammar), or None. Read per call, like QFEDX_TRACE.
    Inline ``{...}`` values are cached by their literal text; a FILE
    path is re-read on every resolve — an operator editing the plan
    behind an unchanged path must not be served a stale parse (the
    per-call contract), and the files are tiny."""
    value = pins.str_pin("QFEDX_FAULTS", "")
    if value.lower() in ("", "0", "off"):
        return None
    if value.lstrip().startswith("{"):
        return _inline_plan(value)
    return FaultPlan.from_json(value)


def resolve_plan(fault_plan: FaultPlan | None = None) -> FaultPlan | None:
    """An explicit plan argument wins; otherwise the QFEDX_FAULTS pin."""
    return fault_plan if fault_plan is not None else active_plan()
