"""Chat traffic: the paper's dialogue corpus under open-loop Poisson arrivals.

Frozen copy for the benchmark, so that a change to the program cannot
change the traffic it is measured with.  Copied from the port at commit
bdcad9e275c09ab563fad5e5900be9a462e243e1:

  * the template banks, ``_gen_one``, ``Task``, ``make_task``,
    ``VARIANCE_MIXES``, ``generate_corpus`` and ``train_test_split`` from
    ``src/repro_torch/core/datagen.py`` (``UNCERTAINTY_TYPES`` from
    ``src/repro_torch/core/rulegen.py``);
  * ``Persona`` and ``PERSONAS`` from ``src/repro_torch/core/personas.py``;
  * the exponential inter-arrival gaps of ``constant_rate_trace`` from
    ``src/repro_torch/core/workload.py``.

One change of method: every seed gets the same work in another order.
The corpus, its split and the multiset of requests are fixed by the mix
file, and so is the arrival schedule: the ``n`` mid-quantiles of the
exponential inter-arrival distribution at the cell's rate, in an order
drawn once from the mix's ``arrival_seed`` (a Poisson stream's gaps, the
same bursts for every seed).  Each arrival time keeps one output length
for every seed, and ``--seed`` deals out the prompts of each length
among the arrival times of that length.  Two seeds then differ in which
prompt comes when (and so in m_theta's scores and the queue's order),
not in how much there is to do or when it comes, and the spread between
seeds is the system's and not the draw's.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Dict, List, Optional, Sequence

import numpy as np

UNCERTAINTY_TYPES = ("structural", "syntactic", "semantic", "vague",
                     "open_ended", "multi_part")

# ---------------------------------------------------------------------------
# personas (copy of core/personas.py)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Persona:
    name: str
    batch_size: int          # C_f      (paper Fig. 8a)
    malicious_tau: float     # tau_f    (paper Fig. 8b, k=0.9)
    eta: float               # eta_f    s/output-token (paper §V-A)
    phi: float               # phi_f    s/input-token  (paper §V-A)
    base_output: float       # output-length intercept (tokens)
    uncertainty_gain: float  # tokens of output per unit true uncertainty
    noise_std: float         # output-length noise (tokens)
    setup_time: float        # per-batch fixed cost (s)
    cpu_slowdown: float      # CPU-lane execution multiplier
    max_output: int = 128
    item_time: float = 0.02  # per-batch-member cost (s)

    def output_latency(self, out_len: float) -> float:
        return self.setup_time + self.eta * out_len + self.item_time

    def batch_latency(self, out_lens) -> float:
        return (self.setup_time + self.eta * max(out_lens)
                + self.item_time * len(out_lens))


PERSONAS: Dict[str, Persona] = {
    "dialogpt": Persona("dialogpt", 11, 35.0, 0.05, 0.08,
                        base_output=8.0, uncertainty_gain=2.6,
                        noise_std=2.5, setup_time=0.11, cpu_slowdown=3.0),
    "godel": Persona("godel", 24, 34.0, 0.04, 0.10,
                     base_output=10.0, uncertainty_gain=2.4,
                     noise_std=2.5, setup_time=0.13, cpu_slowdown=3.5),
    "blenderbot": Persona("blenderbot", 33, 29.0, 0.10, 0.13,
                          base_output=9.0, uncertainty_gain=2.0,
                          noise_std=2.0, setup_time=0.16, cpu_slowdown=4.0),
    "bart": Persona("bart", 11, 26.0, 0.05, 0.08,
                    base_output=7.0, uncertainty_gain=1.9,
                    noise_std=1.8, setup_time=0.08, cpu_slowdown=2.5),
    "t5": Persona("t5", 33, 22.0, 0.04, 0.07,
                  base_output=6.0, uncertainty_gain=1.6,
                  noise_std=1.6, setup_time=0.09, cpu_slowdown=2.5),
}

# ---------------------------------------------------------------------------
# corpus (copy of core/datagen.py)
# ---------------------------------------------------------------------------

_NAMES = ["john", "mary", "the officer", "my friend", "the teacher",
          "a student", "the doctor", "anna", "the researcher", "tom"]
_NOUNS = ["boy", "dog", "bird", "painting", "robot", "car", "statue",
          "kite", "drone", "violin"]
_PLACES = ["park", "garden", "museum", "street", "library", "station",
           "market", "forest", "harbor", "stadium"]
_INSTR = ["telescope", "camera", "umbrella", "flashlight", "map",
          "binoculars", "ladder", "net", "whistle", "radio"]
_AMBIG_SUBJ = ["rice", "time", "fruit", "sand", "dust", "seed", "water"]
_AMBIG_VERBS = ["flies", "runs", "walks", "races", "files", "rounds"]
_POLY = ["bat", "trunk", "monitor", "bank", "spring", "pitch", "crane",
         "seal", "bolt", "club", "match", "scale", "ring", "wave", "bar",
         "key", "bug", "mole", "port"]
_TOPICS = ["art", "music", "science", "philosophy", "technology",
           "medicine", "education", "architecture", "literature",
           "economics"]
_ISSUES = ["poverty", "climate change", "inequality", "urbanization",
           "automation", "migration", "pollution", "aging populations",
           "misinformation", "unemployment"]
_REGIONS = ["developing countries", "coastal cities", "rural areas",
            "modern societies", "large cities", "small towns"]
_PAIR_A = ["cats", "trains", "novels", "lakes", "pianos", "bees"]
_PAIR_B = ["dogs", "planes", "films", "rivers", "guitars", "ants"]
_ASPECTS = ["behavior", "diet", "cost", "history", "maintenance",
            "social interaction", "structure", "speed", "sound", "habitat"]
_PLAIN = [
    "i had pasta for dinner yesterday.",
    "the train leaves at seven tomorrow.",
    "my sister lives near the station.",
    "it rained all day on monday.",
    "please pass the salt.",
    "the meeting starts at noon.",
    "i bought two tickets for the show.",
    "she finished the report on friday.",
    "the shop closes at nine.",
    "we walked home after lunch.",
]


def _gen_one(utype: str, rng: random.Random):
    """Returns (text, true_uncertainty)."""
    if utype == "structural":
        n_pp = rng.choice([2, 2, 3])
        pps = rng.sample(
            [f"in the {rng.choice(_PLACES)}", f"with a {rng.choice(_INSTR)}",
             f"near the {rng.choice(_PLACES)}", f"by the {rng.choice(_PLACES)}"],
            n_pp)
        text = (f"{rng.choice(_NAMES)} saw a {rng.choice(_NOUNS)} "
                + " ".join(pps) + ".")
        u = 2.0 + 1.6 * (n_pp - 1) + rng.uniform(-0.4, 0.4)
    elif utype == "syntactic":
        n = rng.choice([1, 2, 2, 3])
        subj = rng.choice(_AMBIG_SUBJ)
        verb = rng.choice(_AMBIG_VERBS)
        tail = rng.choice(["like sand", "like an arrow", "like a bird",
                           "like water"])
        extra = " and ".join(rng.sample(_AMBIG_VERBS, max(0, n - 1)))
        text = f"{subj} {verb} {tail}" + (f" and {extra}." if extra else ".")
        u = 1.6 + 1.2 * n + rng.uniform(-0.4, 0.4)
    elif utype == "semantic":
        n = rng.choice([1, 2, 2, 3])
        words = rng.sample(_POLY, n)
        frame = rng.choice([
            "what's the best way to deal with {w}?",
            "i saw a {w} near the {p}.",
            "can you explain what a {w} is?",
            "the {w} by the {p} surprised everyone.",
        ])
        text = frame.format(w=words[0], p=rng.choice(_PLACES))
        for w in words[1:]:
            text += f" also, what about the {w}?"
        u = 3.0 + 1.8 * n + rng.uniform(-0.5, 0.5)
    elif utype == "vague":
        depth = rng.choice([1, 2, 2, 3])
        text = rng.choice([
            "tell me about the {a} of {t}.",
            "can you talk about the {a} of {t}?",
            "i want to know about the {a} of {t} in general.",
        ]).format(a=rng.choice(["history", "nature", "philosophy",
                                "meaning", "future"]),
                  t=rng.choice(_TOPICS))
        if depth >= 2:
            text += " cover many broad aspects."
        if depth >= 3:
            text += " include the whole general context."
        u = 5.5 + 1.8 * depth + rng.uniform(-0.6, 0.6)
    elif utype == "open_ended":
        depth = rng.choice([1, 2, 2, 3])
        text = rng.choice([
            "what are the causes and consequences of {i} in {r}?",
            "why do {i} keep getting worse in {r}?",
            "how could {r} address {i} over time?",
            "what do you think about {i}?",
        ]).format(i=rng.choice(_ISSUES), r=rng.choice(_REGIONS))
        if depth >= 2:
            text += " please give reasons and implications."
        if depth >= 3:
            text += " what is the long term significance?"
        u = 6.0 + 2.0 * depth + rng.uniform(-0.7, 0.7)
    elif utype == "multi_part":
        k = rng.choice([2, 3, 3, 4])
        aspects = rng.sample(_ASPECTS, k)
        text = (f"how do {rng.choice(_PAIR_A)} and {rng.choice(_PAIR_B)} "
                f"differ in {', '.join(aspects[:-1])}, and {aspects[-1]}?")
        if rng.random() < 0.4:
            text += " and which is better overall?"
        u = 5.0 + 1.7 * k + rng.uniform(-0.6, 0.6)
    else:  # plain
        text = rng.choice(_PLAIN)
        u = 0.4 + 0.08 * len(text.split()) + rng.uniform(-0.2, 0.2)
    return text, max(0.1, u)


@dataclasses.dataclass
class Task:
    """One corpus utterance with its true output length per persona."""
    text: str
    utype: str
    true_u: float
    out_lens: Dict[str, int]
    task_id: int = -1
    arrival: float = 0.0
    deadline: Optional[float] = None
    malicious: bool = False


def make_task(utype: str, rng: random.Random, task_id: int = -1,
              malicious: bool = False) -> Task:
    text, u = _gen_one(utype, rng)
    if malicious:
        text += (" i talk a lot and it is fun to learn about it with some"
                 " other guys. tell me about the history of art, the"
                 " meaning of life, and what you think about the future.")
        u = u + 12.0 + rng.uniform(0, 6.0)
    out_lens = {}
    for name, p in PERSONAS.items():
        ln = p.base_output + p.uncertainty_gain * u + \
            rng.gauss(0.0, p.noise_std)
        out_lens[name] = int(np.clip(round(ln), 1, p.max_output))
    return Task(text=text, utype=utype, true_u=u, out_lens=out_lens,
                task_id=task_id, malicious=malicious)


VARIANCE_MIXES = {
    "small": {"plain": .60, "structural": .10, "syntactic": .10,
              "semantic": .20, "vague": 0.0, "open_ended": 0.0,
              "multi_part": 0.0},
    "normal": {"plain": .30, "structural": .08, "syntactic": .07,
               "semantic": .15, "vague": .15, "open_ended": .15,
               "multi_part": .10},
    "large": {"plain": .25, "structural": .05, "syntactic": .05,
              "semantic": .10, "vague": .15, "open_ended": .20,
              "multi_part": .20},
}


def generate_corpus(mix: Dict[str, float], n: int, seed: int = 0,
                    malicious_frac: float = 0.0) -> List[Task]:
    rng = random.Random(seed)
    types = list(mix)
    weights = [mix[t] for t in types]
    tasks = []
    for i in range(n):
        utype = rng.choices(types, weights)[0]
        mal = rng.random() < malicious_frac
        tasks.append(make_task(utype, rng, task_id=i, malicious=mal))
    return tasks


def train_test_split(tasks: Sequence[Task], train_frac: float = 0.7,
                     seed: int = 0):
    idx = list(range(len(tasks)))
    random.Random(seed).shuffle(idx)
    cut = int(len(tasks) * train_frac)
    return [tasks[i] for i in idx[:cut]], [tasks[i] for i in idx[cut:]]


# ---------------------------------------------------------------------------
# the generator the harness calls
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Traffic:
    persona: Persona          # with batch_size set to the engine's slots
    train: List[Task]         # m_theta's training half
    # the requests in arrival order: dicts of text, arrival (engine-clock
    # seconds), max_new_tokens (the output length; EOS is disabled)
    requests: List[dict]


def exponential_gaps(n: int, rate: float) -> np.ndarray:
    """The ``n`` mid-quantiles of the exponential inter-arrival
    distribution at ``rate`` per second: the gaps a Poisson stream of
    ``n`` arrivals takes, as a fixed set."""
    q = (np.arange(n, dtype=np.float64) + 0.5) / n
    return -np.log1p(-q) / rate


def make(params: dict, *, rate: float, seconds: float, seed: int,
         num_slots: int, stream: int = 0) -> Traffic:
    """The cell's traffic at ``rate`` requests per engine-clock second
    over ``seconds``.  ``stream`` > 0 gives the set-up's warm-up requests,
    drawn apart from the measured ones."""
    persona = dataclasses.replace(PERSONAS[params["persona"]],
                                  batch_size=num_slots)
    corpus = generate_corpus(VARIANCE_MIXES[params["mix"]],
                             params["corpus_size"],
                             seed=params["corpus_seed"])
    train, test = train_test_split(corpus, train_frac=params["train_frac"],
                                   seed=params["corpus_seed"])
    n = max(1, int(round(rate * seconds)))
    gaps = np.random.default_rng(params["arrival_seed"]).permutation(
        exponential_gaps(n, rate))
    arrivals = np.cumsum(gaps)
    # the arrival slots' output lengths are fixed; the seed deals out the
    # prompts of each length among the slots of that length
    base = [test[i % len(test)] for i in range(n)]
    rng = np.random.default_rng([seed, stream])
    by_len: Dict[int, List[int]] = {}
    for i, t in enumerate(base):
        by_len.setdefault(t.out_lens[persona.name], []).append(i)
    pick = list(range(n))
    for slots in by_len.values():
        for i, j in zip(slots, rng.permutation(slots)):
            pick[i] = int(j)
    requests = [{"text": base[pick[i]].text, "arrival": float(arrivals[i]),
                 "max_new_tokens": base[pick[i]].out_lens[persona.name]}
                for i in range(n)]
    return Traffic(persona=persona, train=train, requests=requests)


def describe(params: dict) -> dict:
    """Lengths of the mix's test half, for the record: words a prompt
    (one word is one token) and the output lengths."""
    corpus = generate_corpus(VARIANCE_MIXES[params["mix"]],
                             params["corpus_size"],
                             seed=params["corpus_seed"])
    _, test = train_test_split(corpus, train_frac=params["train_frac"],
                               seed=params["corpus_seed"])
    words = [len(t.text.split()) for t in test]
    outs = [t.out_lens[params["persona"]] for t in test]
    return {"prompt_words_max": max(words),
            "out_min": min(outs), "out_max": max(outs),
            "out_mean": float(np.mean(outs)),
            "out_p95": float(np.percentile(outs, 95)),
            "n_test": len(test)}

