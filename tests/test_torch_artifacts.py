"""The kernel build cache and the kernel-library artifact store:
integrity, fallback and concurrency contracts, on the CPU.

The store's one promise is that it can only ever REMOVE builds from a
restart, never change results or add failure modes: every corruption or
mismatch path is a journaled miss (the caller builds the same source),
and a library taken from the store runs bit-identically to the one that
was built. This sandbox has no ``nvcc``, so the libraries here are host
libraries built by ``g++`` — directly, and through ``_build.library``
with a stub compiler in ``nvcc``'s place.
"""

import ctypes
import json
import os
import stat
import subprocess
import sys
import textwrap
import zlib

import pytest

from deap_tpu_torch import _build, tuning
from deap_tpu_torch.support import artifacts, compilecache
from deap_tpu_torch.support.artifacts import (ARTIFACT_JOURNAL_KINDS,
                                              ExecutableArtifactStore,
                                              active_store,
                                              disable_artifact_store,
                                              enable_artifact_store)
from deap_tpu_torch.telemetry.journal import RunJournal, read_journal
from deap_tpu_torch.telemetry import report

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: what the stub compiler builds for any source: the launcher interface
#: ``_build.library`` binds, and a function to call
HOST_SOURCE = """
extern "C" const char* dtt_error_string(int e) { return "no error"; }
extern "C" int answer(int x) { return 6 * x + 0x5a; }
"""


def _rows(path, kind):
    return [e for e in read_journal(str(path)) if e.get("kind") == kind]


def _host_library(tmp_path, name="libanswer.so"):
    src = tmp_path / "answer.cpp"
    src.write_text(HOST_SOURCE)
    out = tmp_path / name
    subprocess.run(["g++", "-shared", "-fPIC", "-O2", str(src), "-o",
                    str(out)], check=True)
    return out


def _answer(path, x=7):
    lib = ctypes.CDLL(str(path))
    lib.answer.argtypes = [ctypes.c_int]
    return lib.answer(x)


@pytest.fixture(autouse=True)
def _no_store():
    disable_artifact_store()
    yield
    disable_artifact_store()


# ------------------------------------------------------------- the store ----

def test_round_trip_bit_identity(tmp_path):
    built = _host_library(tmp_path)
    store = ExecutableArtifactStore(str(tmp_path / "a"))
    assert store.put("answer", "h1", str(built))

    # a FRESH store over the same directory (the restarted process)
    jpath = tmp_path / "j.jsonl"
    with RunJournal(str(jpath)):
        blob = ExecutableArtifactStore(str(tmp_path / "a")).get("answer",
                                                                "h1")
    assert blob == built.read_bytes()
    copy = tmp_path / "copy.so"
    copy.write_bytes(blob)
    assert _answer(copy) == _answer(built) == 6 * 7 + 0x5a
    hits = _rows(jpath, "artifact_hit")
    assert len(hits) == 1 and hits[0]["hlo_hash"] == "h1"
    assert hits[0]["bytes"] == len(blob) and hits[0]["label"] == "answer"


@pytest.mark.parametrize("damage", ["flip", "truncate"])
def test_corrupt_blob_falls_back_to_build(tmp_path, damage):
    built = _host_library(tmp_path)
    store = ExecutableArtifactStore(str(tmp_path / "a"))
    assert store.put("answer", "h1", str(built))
    blob = store._blob_path(store.key_for("h1"))
    raw = open(blob, "rb").read()
    mid = len(raw) // 2
    bad = (raw[:mid] + bytes([raw[mid] ^ 0xFF]) + raw[mid + 1:]
           if damage == "flip" else raw[: len(raw) // 3])
    with open(blob, "wb") as fh:
        fh.write(bad)

    jpath = tmp_path / "j.jsonl"
    with RunJournal(str(jpath)):
        assert ExecutableArtifactStore(str(tmp_path / "a")).get(
            "answer", "h1") is None
    misses = _rows(jpath, "artifact_miss")
    assert len(misses) == 1 and misses[0]["reason"] == "crc_mismatch"
    # ... and the caller's build of the same source is the result the
    # store would have given
    assert _answer(_host_library(tmp_path, "rebuilt.so")) == _answer(built)


@pytest.mark.parametrize("field", artifacts.STAMP_FIELDS)
def test_stamp_mismatch_skips_entry(tmp_path, field):
    store = ExecutableArtifactStore(str(tmp_path / "a"))
    assert store.put("answer", "h1", b"library bytes")
    assert set(store.stamp()) == set(artifacts.STAMP_FIELDS)
    doc = json.load(open(store.manifest_path))
    for entry in doc["entries"].values():
        entry[field] = "another"
    with open(store.manifest_path, "w") as fh:
        json.dump(doc, fh)

    jpath = tmp_path / "j.jsonl"
    with RunJournal(str(jpath)):
        assert ExecutableArtifactStore(str(tmp_path / "a")).get(
            "answer", "h1") is None
    assert _rows(jpath, "artifact_miss")[0]["reason"] == "stamp_mismatch"


def test_missing_key_is_a_journaled_miss(tmp_path):
    jpath = tmp_path / "j.jsonl"
    with RunJournal(str(jpath)):
        assert ExecutableArtifactStore(str(tmp_path / "a")).get(
            "answer", "never-built") is None
    assert _rows(jpath, "artifact_miss")[0]["reason"] == "absent"


def test_concurrent_read_merge_write_merges_both(tmp_path):
    """Two store instances over one directory — two processes' puts.
    Both entries survive the merge."""
    a = ExecutableArtifactStore(str(tmp_path / "a"))
    b = ExecutableArtifactStore(str(tmp_path / "a"))
    assert a.put("fa", "ha", b"first library")
    # b's in-memory manifest predates a's put; its own put must merge
    assert b.put("fb", "hb", b"second library")
    fresh = ExecutableArtifactStore(str(tmp_path / "a"))
    assert fresh.get("fa", "ha") == b"first library"
    assert fresh.get("fb", "hb") == b"second library"


def test_manifest_and_blobs_read_without_torch(tmp_path):
    """The manifest is stdlib JSON and a blob is the library's bytes:
    tooling can inventory and check a store with no torch importable."""
    store = ExecutableArtifactStore(str(tmp_path / "a"))
    assert store.put("answer", "h1", str(_host_library(tmp_path)))
    mod_path = os.path.join(REPO, "deap_tpu_torch", "support",
                            "artifacts.py")
    child = textwrap.dedent(f"""
        import builtins, importlib.util, os, sys, zlib
        real_import = builtins.__import__
        def guard(name, *a, **k):
            if name.split(".")[0] in ("torch", "jax", "deap_tpu_torch"):
                raise AssertionError(name + " imported in the child")
            return real_import(name, *a, **k)
        builtins.__import__ = guard
        spec = importlib.util.spec_from_file_location(
            "artifacts_standalone", {mod_path!r})
        mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mod
        spec.loader.exec_module(mod)
        store = mod.ExecutableArtifactStore({str(tmp_path / "a")!r})
        entry = next(iter(store._entries.values()))
        raw = open(os.path.join(store.directory, entry["file"]), "rb").read()
        assert zlib.crc32(raw) == entry["crc"] and len(raw) == entry["bytes"]
        print("OK", len(store._entries), entry["label"])
    """)
    out = subprocess.run([sys.executable, "-c", child],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("OK 1 answer")


def test_enable_is_idempotent_and_disable_restores(tmp_path):
    s1 = enable_artifact_store(str(tmp_path / "a"))
    s2 = enable_artifact_store(str(tmp_path / "a"))
    assert s1 is s2 and active_store() is s1
    disable_artifact_store()
    assert active_store() is None


def test_journal_kinds_are_tallied_by_the_report(tmp_path):
    """Every kind this module writes is tallied by the report's startup
    ledger."""
    jpath = str(tmp_path / "j.jsonl")
    store = ExecutableArtifactStore(str(tmp_path / "a"))
    with RunJournal(jpath):
        store.get("answer", "h1")
        store.put("answer", "h1", b"library bytes")
        store.get("answer", "h1")
    assert {r["kind"] for r in read_journal(jpath)} >= set(
        ARTIFACT_JOURNAL_KINDS)
    out = []
    report._startup_section(read_journal(jpath), out)
    assert any("artifact store: 1/2 hit(s)" in line for line in out)


# ------------------------------------------- the build seam (_build.py) ----

@pytest.fixture
def stub_nvcc(tmp_path, monkeypatch):
    """``nvcc`` replaced by a script that builds :data:`HOST_SOURCE` with
    ``g++`` for any source, a private build directory, no loaded library.
    ``calls`` lists the builds it ran; ``refuse()`` makes every later
    build fail."""
    src = tmp_path / "host.cpp"
    src.write_text(HOST_SOURCE)
    log = tmp_path / "nvcc_calls"
    stub = tmp_path / "nvcc"
    stub.write_text(textwrap.dedent(f"""\
        #!{sys.executable}
        import os, subprocess, sys
        args = sys.argv[1:]
        if args == ["--version"]:
            print("stub nvcc\\nBuild stub_1.0")
            sys.exit(0)
        if os.path.exists({str(tmp_path / "refuse")!r}):
            sys.exit(3)
        out = args[args.index("-o") + 1]
        open({str(log)!r}, "a").write(out + "\\n")
        sys.exit(subprocess.call(["g++", "-shared", "-fPIC",
                                  {str(src)!r}, "-o", out]))
        """))
    stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(stub))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(compilecache, "_enabled_path", None)
    _build.nvcc_version.cache_clear()

    class Stub:
        @staticmethod
        def calls():
            return log.read_text().split() if log.exists() else []

        @staticmethod
        def refuse():
            (tmp_path / "refuse").write_text("")

        @staticmethod
        def fresh_process(build_dir):
            """A new process's view: another build directory, nothing
            loaded."""
            monkeypatch.setattr(_build, "BUILD_DIR", build_dir)
            monkeypatch.setattr(_build, "_LIBS", {})

    yield Stub
    _build.nvcc_version.cache_clear()


def _library_answer(name="fused_variation"):
    lib = _build.library(name)
    lib.answer.argtypes = [ctypes.c_int]
    return lib.answer(7)


def test_build_takes_the_library_from_the_store(tmp_path, stub_nvcc):
    """A miss builds and puts; a process with an empty build directory
    then copies the library in (``artifact_hit``) with no build; a
    corrupted blob is a miss that rebuilds the same source and heals the
    store."""
    store = enable_artifact_store(str(tmp_path / "store"))
    assert store.stamp()["nvcc"] == "Build stub_1.0"
    jpath = tmp_path / "j.jsonl"
    with RunJournal(str(jpath)):
        t0 = _build.COMPILE_SECONDS[0]
        want = _library_answer()
        assert len(stub_nvcc.calls()) == 1
        assert _build.COMPILE_SECONDS[0] > t0
        stub_nvcc.fresh_process(tmp_path / "b2")
        stub_nvcc.refuse()  # a build now would fail the load
        t1 = _build.COMPILE_SECONDS[0]
        assert _library_answer() == want
        assert _build.COMPILE_SECONDS[0] == t1
        assert len(stub_nvcc.calls()) == 1
    assert [r["reason"] for r in _rows(jpath, "artifact_miss")] == ["absent"]
    hits = _rows(jpath, "artifact_hit")
    assert len(hits) == 1 and hits[0]["label"] == "fused_variation"
    assert hits[0]["hlo_hash"] == _build.source_hash("fused_variation")
    assert len(_rows(jpath, "compile")) == 1

    # corrupt the blob: a miss, the same source rebuilt, the store healed
    (tmp_path / "refuse").unlink()
    entry = next(iter(store._read_manifest().values()))
    blob = os.path.join(store.directory, entry["file"])
    with open(blob, "r+b") as fh:
        fh.seek(100)
        fh.write(b"\xff\xff")
    stub_nvcc.fresh_process(tmp_path / "b3")
    jpath2 = tmp_path / "j2.jsonl"
    with RunJournal(str(jpath2)):
        assert _library_answer() == want
    assert _rows(jpath2, "artifact_miss")[0]["reason"] == "crc_mismatch"
    assert len(stub_nvcc.calls()) == 2
    raw = open(blob, "rb").read()
    assert zlib.crc32(raw) == next(iter(
        store._read_manifest().values()))["crc"]


def test_compile_cache_loads_without_a_build(tmp_path, monkeypatch,
                                             stub_nvcc):
    """The build cache: a second process pointed at the same directory
    loads the library with no build; the tuning cache and the artifact
    store default to living beside it."""
    cc = str(tmp_path / "cc")
    jpath = tmp_path / "j.jsonl"
    with RunJournal(str(jpath)):
        assert compilecache.enable_compile_cache(cc) == cc
        assert compilecache.enable_compile_cache(cc) == cc  # idempotent
    assert [r["path"] for r in _rows(jpath, "compile_cache")] == [cc]
    assert compilecache.enabled_path() == compilecache.sibling_cache_dir() \
        == cc and str(_build.BUILD_DIR) == cc
    want = _library_answer()
    assert len(stub_nvcc.calls()) == 1
    assert os.listdir(cc) and all(
        p.startswith(cc) for p in stub_nvcc.calls())
    stub_nvcc.fresh_process(_build.BUILD_DIR)
    stub_nvcc.refuse()
    assert _library_answer() == want and len(stub_nvcc.calls()) == 1
    monkeypatch.delenv(tuning.cache.ENV_DIR, raising=False)
    monkeypatch.delenv(artifacts.ENV_VAR, raising=False)
    assert tuning.default_dir() == cc
    assert artifacts.default_dir() == os.path.join(cc, "artifacts")
    store = compilecache.enable_artifact_cache()
    assert store is active_store() and store.directory == os.path.join(
        cc, "artifacts")


def test_enable_from_env(tmp_path, monkeypatch, stub_nvcc):
    monkeypatch.delenv(compilecache.ENV_VAR, raising=False)
    assert compilecache.enable_from_env() is None
    monkeypatch.setenv(compilecache.ENV_VAR, str(tmp_path / "envcc"))
    assert compilecache.enable_from_env() == str(tmp_path / "envcc")
    assert str(_build.BUILD_DIR) == str(tmp_path / "envcc")
