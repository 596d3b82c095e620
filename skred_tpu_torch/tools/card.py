"""The card a tool runs on: its name and power limit as nvidia-smi gives
them, and the check every tool makes of its ``--device``: the tools run
on the card unless the caller passes ``--device cpu``, and with no card
they stop with an error line, never falling back to the CPU.  Also the
timing-ablation switches' guard: a tool whose numbers are headlines
refuses to start under ``SKRED_MEGA_ABLATE`` or ``SKRED_CYC_ABLATE``."""

import subprocess
import sys

import torch


def card_info(device) -> dict:
    """The card's name and power limit as nvidia-smi gives them."""
    if torch.device(device).type != "cuda":
        return {"name": str(device), "power_limit": None}
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name, limit = (s.strip() for s in out.split(","))
    return {"name": name, "power_limit": limit}


def require(device, prog: str, fail=None) -> None:
    """Exit 2 with an error line when ``device`` is a card and there is
    none: ``fail(message, 2)`` where the caller reports errors its own
    way, else a line on stderr."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        msg = (f"{prog}: torch.cuda.is_available() is false: this runs on "
               f"the card (pass --device cpu for the CPU)")
        if fail is not None:
            fail(msg, 2)
        print(msg, file=sys.stderr, flush=True)
        raise SystemExit(2)


def sync(device):
    """``torch.cuda.synchronize`` on a card, nothing on the CPU."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def ablated() -> dict:
    """{variable: sorted phases} of the ablation switches that are set to
    a nonempty set (``engine/kernels/tier.py`` MEGA_ABLATE,
    ``engine/kernels/cyclic.py`` CYC_ABLATE)."""
    from skred_tpu_torch.engine.kernels import cyclic, tier

    return {var: sorted(on) for var, on in (
        ("SKRED_MEGA_ABLATE", tier.MEGA_ABLATE),
        ("SKRED_CYC_ABLATE", cyclic.CYC_ABLATE)) if on}


def ablated_tag() -> str:
    """"ABLATED <set>" for every line a tool prints under a nonempty
    ablation set ("" otherwise): its renders are invalid, its walls are
    a stubbed kernel's."""
    on = ablated()
    return "ABLATED " + " ".join(f"{var}={','.join(ph)}"
                                 for var, ph in on.items()) if on else ""


def refuse_ablated(prog: str, fail=None) -> None:
    """Exit 2 with an error line when an ablation switch is set: an
    ablated render is invalid by design, so a tool whose numbers are
    headlines or parity refuses to start (``fail(message, 2)`` where the
    caller reports errors its own way)."""
    on = ablated()
    if not on:
        return
    msg = (f"{prog}: refusing to run under timing ablation "
           f"({ablated_tag()[len('ABLATED '):]}): its renders are invalid; "
           f"unset the variable")
    if fail is not None:
        fail(msg, 2)
    print(msg, file=sys.stderr, flush=True)
    raise SystemExit(2)
