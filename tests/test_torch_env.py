"""The port's CraftEnv parses every CRAFT_* knob as the reference does:
equal fields over a table of environments, and the same ValueError cases."""
import dataclasses

import pytest

from repro.core.env import CraftEnv as RefEnv
from repro_torch.core.env import CraftEnv as PortEnv

ENVIRONS = [
    {},
    {"CRAFT_CP_PATH": "/x/pfs", "CRAFT_NODE_CP_PATH": "/x/node"},
    {"CRAFT_ENABLE": "0", "CRAFT_READ_CP_ON_RESTART": "0"},
    {"CRAFT_WRITE_ASYNC": "1", "CRAFT_IO_WORKERS": "4",
     "CRAFT_ASYNC_THREAD_PIN_CPULIST": "0_2_4"},
    {"CRAFT_USE_SCR": "0"},
    {"CRAFT_NODE_REDUNDANCY": "xor", "CRAFT_XOR_GROUP_SIZE": "3"},
    {"CRAFT_NODE_REDUNDANCY": "RS", "CRAFT_RS_PARITY": "3"},
    {"CRAFT_COMPRESS": "ZSTD", "CRAFT_ZSTD_LEVEL": "9",
     "CRAFT_ZSTD_GATE_BITS": "7.5"},
    {"CRAFT_CHECKSUM": "none", "CRAFT_CODEC_VERSION": "0"},
    {"CRAFT_DELTA": "1", "CRAFT_DELTA_MAX_CHAIN": "2"},
    {"CRAFT_CODEC_VERSION": "2"},
    {"CRAFT_DEVICE_SNAPSHOT": "1", "CRAFT_CHUNK_BYTES": "65536"},
    {"CRAFT_RESHARD": "RANGE", "CRAFT_ELASTIC_HYDRATE": "0"},
    {"CRAFT_TIER_CHAIN": "mem,node,pfs", "CRAFT_MEM_REPLICAS": "2",
     "CRAFT_MEM_BUDGET_BYTES": "1000"},
    {"CRAFT_TIER_CHAIN": " pfs "},
    {"CRAFT_TIER_EVERY": "mem:1,node:8,pfs:64"},
    {"CRAFT_TIER_EVERY": "auto", "CRAFT_MTBF_SECONDS": "3600"},
    {"CRAFT_WALLTIME_SECONDS": "7200", "CRAFT_WALLTIME_MARGIN_SECONDS": "30"},
    {"CRAFT_CP_SIGNAL": "SIGUSR1"},
    {"CRAFT_SCRUB_EVERY": "0.5", "CRAFT_SCRUB_BYTES_PER_S": "1e6"},
    {"CRAFT_CHAOS": "pfs:eio:p=0.3", "CRAFT_CHAOS_SEED": "42",
     "CRAFT_IO_RETRIES": "5", "CRAFT_IO_BACKOFF_MS": "1"},
    {"CRAFT_IO_DEADLINE_S": "2", "CRAFT_BREAKER_THRESHOLD": "1",
     "CRAFT_BREAKER_COOLDOWN_S": "0.05"},
    {"CRAFT_TRACE": "/x/trace.jsonl", "CRAFT_TUNE_ONLINE": "1",
     "CRAFT_TUNE_EVERY_S": "5"},
    {"CRAFT_METRICS": "1"},
    {"CRAFT_METRICS_PORT": "0"},
    {"CRAFT_COMM_RECOVERY_POLICY": "shrinking",
     "CRAFT_COMM_SPAWN_POLICY": "reuse"},
]

BAD = [
    {"CRAFT_COMM_RECOVERY_POLICY": "sideways"},
    {"CRAFT_COMM_SPAWN_POLICY": "maybe"},
    {"CRAFT_NODE_REDUNDANCY": "RAID6"},
    {"CRAFT_RS_PARITY": "0"},
    {"CRAFT_COMPRESS": "lz4"},
    {"CRAFT_ZSTD_LEVEL": "23"},
    {"CRAFT_ZSTD_GATE_BITS": "9"},
    {"CRAFT_CHECKSUM": "md5"},
    {"CRAFT_CODEC_VERSION": "3"},
    {"CRAFT_DELTA": "1", "CRAFT_CODEC_VERSION": "0"},
    {"CRAFT_DELTA_MAX_CHAIN": "0"},
    {"CRAFT_CHUNK_BYTES": "0"},
    {"CRAFT_RESHARD": "sometimes"},
    {"CRAFT_TIER_CHAIN": "pfs,pfs"},
    {"CRAFT_TIER_CHAIN": "disk"},
    {"CRAFT_TIER_CHAIN": ","},
    {"CRAFT_MEM_REPLICAS": "-1"},
    {"CRAFT_MEM_BUDGET_BYTES": "-5"},
    {"CRAFT_MTBF_SECONDS": "-1"},
    {"CRAFT_WALLTIME_SECONDS": "-1"},
    {"CRAFT_WALLTIME_MARGIN_SECONDS": "-1"},
    {"CRAFT_SCRUB_EVERY": "-1"},
    {"CRAFT_SCRUB_BYTES_PER_S": "-1"},
    {"CRAFT_CHAOS": "pfs:explode"},
    {"CRAFT_IO_RETRIES": "-1"},
    {"CRAFT_IO_BACKOFF_MS": "-1"},
    {"CRAFT_IO_DEADLINE_S": "-1"},
    {"CRAFT_BREAKER_THRESHOLD": "0"},
    {"CRAFT_BREAKER_COOLDOWN_S": "-1"},
    {"CRAFT_TUNE_EVERY_S": "0"},
    {"CRAFT_METRICS_PORT": "70000"},
]


def _fields(env) -> dict:
    return {f.name: getattr(env, f.name) for f in dataclasses.fields(env)}


def test_same_field_set():
    assert ([f.name for f in dataclasses.fields(PortEnv)]
            == [f.name for f in dataclasses.fields(RefEnv)])


@pytest.mark.parametrize("environ", ENVIRONS,
                         ids=[",".join(e) or "defaults" for e in ENVIRONS])
def test_capture_matches_reference(environ):
    assert _fields(PortEnv.capture(environ)) == _fields(RefEnv.capture(environ))


@pytest.mark.parametrize("environ", BAD, ids=[",".join(e) for e in BAD])
def test_invalid_knobs_raise_in_both(environ):
    with pytest.raises(ValueError):
        RefEnv.capture(environ)
    with pytest.raises(ValueError):
        PortEnv.capture(environ)


def test_tier_every_lookup_matches():
    environ = {"CRAFT_TIER_EVERY": "node:4,pfs:auto"}
    ref, port = RefEnv.capture(environ), PortEnv.capture(environ)
    for slot in ("mem", "node", "pfs"):
        assert port.tier_every_for(slot) == ref.tier_every_for(slot)
