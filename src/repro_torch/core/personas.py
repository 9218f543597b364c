"""Length/latency personas for the paper's five evaluated LMs.

The container is offline (no HuggingFace weights), so the five LMs —
DialoGPT-medium, GODEL-v1_1-base, BlenderBot-400M-distill, BART-base,
T5-base — are emulated as *personas*: per-model coefficient profiles that
map an input's true uncertainty to an output length and the output length
to a latency.  All published constants come straight from the paper
(§V-A Hyper-parameters: batch sizes C_f, malicious thresholds tau_f,
output-latency coefficients eta_f, input-latency coefficients phi_f; §V-H:
~415 ms mean inference latency).  The scheduler under test only ever sees
(features, predicted u, d, r), so fidelity of the *resource-management*
evaluation is preserved.

A sixth entry ("jax-tiny") binds a persona to the real JAX engine for the
end-to-end integration example.
"""

from __future__ import annotations

import dataclasses
from typing import Dict


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
    item_time: float = 0.02  # per-batch-member cost (s) — memory-bandwidth
                             # term of batched decode; keeps oversize
                             # consolidated batches from being free

    def output_latency(self, out_len: float) -> float:
        return self.setup_time + self.eta * out_len + self.item_time

    def batch_latency(self, out_lens) -> float:
        """Batched autoregressive decode runs until the longest member."""
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

PERSONA_NAMES = tuple(PERSONAS)


def get_persona(name: str) -> Persona:
    return PERSONAS[name]


# ---------------------------------------------------------------------------
# hardware platforms (paper §V-E: edge server vs NVIDIA AGX Xavier)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Platform:
    name: str
    speed_factor: float        # execution-time multiplier vs edge server
    cpu_ratio_factor: float    # scales the GPU:CPU gap (embedded SoCs
                               # have a narrower gap: weaker GPU, same-die
                               # memory)


PLATFORMS = {
    # RTX A4500 + 96-core EPYC (Table II)
    "edge_server": Platform("edge_server", 1.0, 1.0),
    # Volta iGPU + 8-core Carmel; ~6x slower absolute, narrower GPU:CPU gap
    "agx_xavier": Platform("agx_xavier", 6.0, 0.7),
}


def on_platform(persona: Persona, platform_name: str) -> Persona:
    """Rescale a persona's latency model to another platform."""
    pf = PLATFORMS[platform_name]
    if pf.speed_factor == 1.0 and pf.cpu_ratio_factor == 1.0:
        return persona
    # NOTE: keep .name unchanged — datagen keys ground-truth output
    # lengths by persona name (lengths are model properties; only the
    # latency coefficients are platform properties).
    return dataclasses.replace(
        persona,
        eta=persona.eta * pf.speed_factor,
        phi=persona.phi * pf.speed_factor,
        setup_time=persona.setup_time * pf.speed_factor,
        item_time=persona.item_time * pf.speed_factor,
        cpu_slowdown=max(1.5, persona.cpu_slowdown * pf.cpu_ratio_factor),
    )
