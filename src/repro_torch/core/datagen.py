"""Synthetic dialogue corpora built from the six-type uncertainty taxonomy.

The paper's own probe set was constructed the same way (§III-A: "we create
1,000 utterances for each of the six uncertainty types"); its four
benchmark datasets (Blended Skill Talk, PersonaChat, ConvAI2, Empathetic
Dialogues) are emulated as four corpora with different *mixes* of the six
types + plain utterances — the statistic that matters to the scheduler is
the induced distribution (variance) of uncertainty scores, which we match
qualitatively to Fig. 3.

Every utterance carries a ground-truth "true uncertainty" u* (derived
from its template slots, NOT from RULEGEN — the predictor must learn the
mapping) and per-persona output lengths sampled as

    len = clip(base_f + gain_f * u* + eps,  1, max_output)

reflecting Fig. 1a: vague/open/multi types induce the longest outputs,
semantic > structural/syntactic among the lexical ambiguities.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Dict, List, Optional, Sequence

import numpy as np

from . import personas as personas_lib
from .rulegen import UNCERTAINTY_TYPES

# ---------------------------------------------------------------------------
# template banks (slot-filled)
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
    """One inference request."""
    text: str
    utype: str
    true_u: float                       # ground-truth uncertainty
    out_lens: Dict[str, int]            # persona -> true output length
    task_id: int = -1
    arrival: float = 0.0                # r_J (set by the workload)
    deadline: Optional[float] = None    # user-specified t_J, usually None
    malicious: bool = False


def make_task(utype: str, rng: random.Random, task_id: int = -1,
              malicious: bool = False) -> Task:
    text, u = _gen_one(utype, rng)
    if malicious:
        # §V-G: adversarially crafted inputs elongating outputs — emulate
        # the attack of [56] by stacking uncertainty markers.
        text += (" i talk a lot and it is fun to learn about it with some"
                 " other guys. tell me about the history of art, the"
                 " meaning of life, and what you think about the future.")
        u = u + 12.0 + rng.uniform(0, 6.0)
    out_lens = {}
    for name, p in personas_lib.PERSONAS.items():
        ln = p.base_output + p.uncertainty_gain * u + \
            rng.gauss(0.0, p.noise_std)
        out_lens[name] = int(np.clip(round(ln), 1, p.max_output))
    return Task(text=text, utype=utype, true_u=u, out_lens=out_lens,
                task_id=task_id, malicious=malicious)


# ---------------------------------------------------------------------------
# corpora
# ---------------------------------------------------------------------------

ALL_TYPES = UNCERTAINTY_TYPES + ("plain",)

# four benchmark-dataset emulations: different six-type mixes
DATASET_MIXES = {
    # BST blends skills -> broad mix
    "blended_skill_talk": {"plain": .30, "structural": .08, "syntactic": .07,
                           "semantic": .15, "vague": .15, "open_ended": .15,
                           "multi_part": .10},
    # persona chit-chat -> mostly plain/vague
    "personachat": {"plain": .45, "structural": .05, "syntactic": .05,
                    "semantic": .10, "vague": .20, "open_ended": .10,
                    "multi_part": .05},
    # convai2 -> questions galore
    "convai2": {"plain": .30, "structural": .05, "syntactic": .05,
                "semantic": .10, "vague": .15, "open_ended": .20,
                "multi_part": .15},
    # empathetic -> open-ended heavy
    "empathetic_dialogues": {"plain": .35, "structural": .04,
                             "syntactic": .04, "semantic": .07,
                             "vague": .15, "open_ended": .25,
                             "multi_part": .10},
}

# §V-B variance subsets
VARIANCE_MIXES = {
    "small": {"plain": .60, "structural": .10, "syntactic": .10,
              "semantic": .20, "vague": 0.0, "open_ended": 0.0,
              "multi_part": 0.0},
    "normal": DATASET_MIXES["blended_skill_talk"],
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


def probe_set(n_per_type: int = 1000, seed: int = 0) -> Dict[str, List[Task]]:
    """§III-A probe: n utterances for each of the six types."""
    out = {}
    for j, utype in enumerate(UNCERTAINTY_TYPES):
        rng = random.Random(seed + 1000 * j)
        out[utype] = [make_task(utype, rng, task_id=i)
                      for i in range(n_per_type)]
    return out


def train_test_split(tasks: Sequence[Task], train_frac: float = 0.7,
                     seed: int = 0):
    idx = list(range(len(tasks)))
    random.Random(seed).shuffle(idx)
    cut = int(len(tasks) * train_frac)
    return [tasks[i] for i in idx[:cut]], [tasks[i] for i in idx[cut:]]
