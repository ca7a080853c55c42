"""Guided decoding in the port against the JAX package, on the CPU: the
port's own copy of engine/guided.py compiles the regexes, choices and
JSON schemas of tests/test_guided.py into the same token DFAs (equal
`trans`, `mask` and `start`) and the same schema regexes; and the port's
ContinuousBatchingScheduler and PagedScheduler, whose DFA states move on
the device, give the JAX schedulers' greedy tokens on the same weights
(a token choice alone, constrained and free requests in one batch, two
constraints in one batch, a JSON schema over a character tokenizer, and
a guided request preempted on a small pool and replayed)."""

import json

import numpy as np
import pytest

from llm_inference_tpu.config import GenerationConfig as JGenerationConfig
from llm_inference_tpu.engine import guided as j_guided
from llm_inference_tpu.engine import scheduler as j_sched

from llm_inference_tpu_torch.config import GenerationConfig
from llm_inference_tpu_torch.engine import guided as t_guided
from llm_inference_tpu_torch.engine import scheduler as t_sched

from torch_bridge import engine_pair


class FakeTok:
    """id ↔ string table tokenizer (tests/test_guided.py's)."""

    def __init__(self, pieces):
        self.pieces = list(pieces)

    def decode_token(self, t):
        return self.pieces[t]

    def decode(self, ids):
        return "".join(self.pieces[t] for t in ids)

    def encode(self, text, add_bos=True):
        raise NotImplementedError


# ------------------------------------------------ the compilers

REGEX_TOK = FakeTok(["<eos>"] + list("abcdexyz.01234567890@_-|\n ")
                    + ["ab", "12", "colo", "ur", ".com", "aa", "cd", ""])
PRINTABLE_TOK = FakeTok([""] + [chr(c) for c in range(32, 127)])
REGEXES = [r"abc", r"a*b", r"a+", r"colou?r", r"(ab|cd)+", r"\d{2,4}",
           r"[a-c]x", r"[^a-c]x", r"a.c", r"-?(0|[1-9]\d*)",
           r"\w+@\w+\.com", r"a{3}", r"(x|y){1,2}", r"ab\|c",
           r"(ab|a)*b", r"\d+(\.\d+)?", r"[ab]c[de]?", r"a(b|c)*d",
           r"x{2,3}y*", r"a{0}b"]
SCHEMAS = {
    "flat": {"type": "object",
             "properties": {"name": {"type": "string"},
                            "age": {"type": "integer"},
                            "ok": {"type": "boolean"}}},
    "enum_number": {"type": "object",
                    "properties": {"kind": {"enum": ["a", "b"]},
                                   "score": {"type": "number"}}},
    "array": {"type": "object",
              "properties": {"xs": {"type": "array",
                                    "items": {"type": "integer"},
                                    "minItems": 1, "maxItems": 3}}},
    "array_one": {"type": "object",
                  "properties": {"xs": {"type": "array",
                                        "items": {"type": "integer"},
                                        "minItems": 1, "maxItems": 1}}},
    "trailing_optional": {"type": "object",
                          "properties": {"a": {"type": "integer"},
                                         "b": {"type": "integer"}},
                          "required": ["a"]},
    "all_optional": {"type": "object",
                     "properties": {"a": {"type": "integer"},
                                    "b": {"type": "integer"}},
                     "required": []},
    "nested": {"type": "object",
               "properties": {
                   "user": {"type": "object",
                            "properties": {"name": {"type": "string"},
                                           "age": {"type": "integer"}}},
                   "ok": {"type": "boolean"}}},
}


def assert_same_dfa(got, want):
    assert got.start == want.start
    np.testing.assert_array_equal(got.trans, want.trans)
    np.testing.assert_array_equal(got.mask, want.mask)
    assert got.key() == want.key()


@pytest.mark.parametrize("pattern", REGEXES)
def test_regex_token_dfa_matches_jax(pattern):
    V = len(REGEX_TOK.pieces)
    got = t_guided.dfa_for_regex(pattern, REGEX_TOK, V, [0])
    want = j_guided.dfa_for_regex(pattern, REGEX_TOK, V, [0])
    assert_same_dfa(got, want)
    seq = [1, 2, 3, 1]
    assert got.walk(seq) == want.walk(seq)


@pytest.mark.parametrize("seqs,eos", [
    ([[3, 4], [3, 5, 6], [7]], [0]), ([[3], [3, 4]], [9]),
    ([[5, 9, 11], [7, 13], [7, 13, 13]], [2, 8])])
def test_token_choices_match_jax(seqs, eos):
    assert_same_dfa(t_guided.from_token_sequences(seqs, 16, eos),
                    j_guided.from_token_sequences(seqs, 16, eos))


def test_string_choices_match_jax():
    tok = FakeTok(["<eos>", "ca", "t", "r", "dog", "c", "a"])
    assert_same_dfa(t_guided.dfa_for_choices(["cat", "car", "dog"], tok, 7,
                                             [0]),
                    j_guided.dfa_for_choices(["cat", "car", "dog"], tok, 7,
                                             [0]))


@pytest.mark.parametrize("name", sorted(SCHEMAS))
def test_json_schema_regex_and_dfa_match_jax(name):
    schema = SCHEMAS[name]
    assert (t_guided.regex_for_json_schema(schema)
            == j_guided.regex_for_json_schema(schema))
    V = len(PRINTABLE_TOK.pieces)
    assert_same_dfa(
        t_guided.dfa_for_json_schema(schema, PRINTABLE_TOK, V, [0]),
        j_guided.dfa_for_json_schema(schema, PRINTABLE_TOK, V, [0]))


@pytest.mark.parametrize("depth", [1, 2])
def test_json_value_regex_matches_jax(depth):
    assert t_guided.json_value_regex(depth) == j_guided.json_value_regex(
        depth)


def test_compile_constraint_refusals_match_jax():
    """The same inputs are refused by both, with the same message."""
    cases = [dict(choice=[[300]]), dict(choice=[[5]], regex="a+"),
             dict(regex="a+"), dict(choice=[]), dict(choice=["cat"])]
    for kw in cases:
        msgs = []
        for mod in (t_guided, j_guided):
            with pytest.raises(ValueError) as e:
                mod.compile_constraint(256, [2], tokenizer=None, **kw)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1], kw
    with pytest.raises(ValueError, match="free-form|properties"):
        t_guided.regex_for_json_schema(
            {"type": "object", "properties": {"o": {"type": "object"}}})


# ------------------------------------------------- schedulers vs JAX

ECFG = dict(max_seq_len=64, decode_chunk=4, max_batch_size=2,
            prefill_buckets=(8, 16), page_size=8)
EOS = 2
# ids 0-2 read as nothing; 3-97 are the printable characters; then a
# few multi-character pieces; the rest read as nothing
CHAR_TOK = FakeTok(["", "", ""] + [chr(c) for c in range(32, 127)]
                   + ['"ok"', "true", "false", ": ", ", ", "red", "green"]
                   + [""] * 151)
JSON_SCHEMA = {"type": "object",
               "properties": {"ok": {"type": "boolean"},
                              "kind": {"enum": ["red", "green"]}}}


@pytest.fixture(scope="module")
def engines():
    return engine_pair("int8", tokenizer=CHAR_TOK, **ECFG)


def _run(mod, eng, name, jobs, max_new=8):
    """Submit (prompt, submit keywords) jobs greedily, run to the end;
    returns (the requests, the scheduler). The paged scheduler's pool is
    8 pages of 8 slots (7 usable), one size for every paged run, so that
    the JAX side compiles its programs once."""
    G = JGenerationConfig if mod is j_sched else GenerationConfig
    kw = {"num_pages": 8} if name == "PagedScheduler" else {}
    sched = getattr(mod, name)(eng, G(greedy=True, max_new_tokens=max_new,
                                      eos_token_ids=(EOS,)), **kw)
    reqs = [sched.submit(list(p), **k) for p, k in jobs]
    while sched.step():
        pass
    return reqs, sched


def _done(r):
    ids = list(r.output_ids)
    return ids[:-1] if ids and ids[-1] == EOS else ids


CHOICES = [[5, 9, 11], [7, 13], [7, 13, 13]]
SCENARIOS = {
    "choice_alone": [([1, 2, 3], dict(guided_choice=CHOICES))],
    "constrained_and_free": [([3, 4, 5], {}),
                             ([6, 7], dict(guided_choice=[[9, 10], [11]])),
                             ([8, 9, 10, 11], {})],
    "two_constraints": [([1, 2], dict(guided_choice=[[5, 6], [8]])),
                        ([3, 4], dict(guided_choice=[[10, 12, 14]]))],
}


@pytest.mark.parametrize("name", ["ContinuousBatchingScheduler",
                                  "PagedScheduler"])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_guided_streams_match_jax_schedulers(engines, name, scenario):
    jeng, teng = engines
    jobs = SCENARIOS[scenario]
    want, _ = _run(j_sched, jeng, name, jobs)
    got, sched = _run(t_sched, teng, name, jobs)
    assert [r.output_ids for r in got] == [r.output_ids for r in want]
    for r, (_, kw) in zip(got, jobs):
        if "guided_choice" in kw:
            assert _done(r) in kw["guided_choice"] and r.finished
    assert (sched.dstate_host == -1).all()      # every constraint is over


def test_json_schema_stream_matches_jax(engines):
    """A flat JSON schema over the character tokenizer: the port's greedy
    text is JAX's, parses, and fits the schema."""
    jeng, teng = engines
    jobs = [([4, 5, 6, 7, 8], dict(guided_json=JSON_SCHEMA)),
            ([9, 10], {})]
    want, _ = _run(j_sched, jeng, "ContinuousBatchingScheduler", jobs, 40)
    got, _ = _run(t_sched, teng, "ContinuousBatchingScheduler", jobs, 40)
    assert [r.output_ids for r in got] == [r.output_ids for r in want]
    obj = json.loads(CHAR_TOK.decode(_done(got[0])))
    assert got[0].finished and set(obj) == {"ok", "kind"}
    assert isinstance(obj["ok"], bool) and obj["kind"] in ("red", "green")


def test_guided_request_preempted_and_replayed_matches_jax(engines):
    """On an 8-page pool (7 usable pages of 8) two long requests cannot
    both hold their pages: the younger, guided one is preempted, replayed
    from its prompt with its DFA state cleared, and still emits its choice
    and the JAX scheduler's tokens."""
    jeng, teng = engines
    rng = np.random.default_rng(2)
    choice = [5, 9, 11, 13, 15, 17, 19]
    jobs = [(rng.integers(3, 256, 15).tolist(), {}),
            (rng.integers(3, 256, 14).tolist(),
             dict(guided_choice=[choice])),
            (rng.integers(3, 256, 6).tolist(), {})]
    want, _ = _run(j_sched, jeng, "PagedScheduler", jobs, 12)
    got, sched = _run(t_sched, teng, "PagedScheduler", jobs, 12)
    assert sched.preemptions > 0
    assert _done(got[1]) == choice
    assert [r.output_ids for r in got] == [r.output_ids for r in want]
