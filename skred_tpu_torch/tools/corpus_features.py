"""Per-script DSP feature usage across the corpus (informs the fused
engine's static specialization).

    python -m skred_tpu_torch.tools.corpus_features [seconds]

A copy of ``tools/corpus_features.py``, verbatim but for its imports
(``skred_tpu_torch``'s copies of the control plane; no JAX, which the
original imported only to keep itself on the CPU) and for the scripts
it walks: the in-repo script folders (``corpus/`` and
``skred_tpu_torch/scripts/``, as ``card_parity.FOLDERS``), in place of
the reference's corpus, which is not in this repository.  The command
line is read in ``main``, not at import.  Numpy only: no device.
"""

import pathlib
import sys

SECONDS = 10.0


def main(seconds=SECONDS, dirs=None):
    from skred_tpu_torch import config as C
    from skred_tpu_torch.assets.bank import WaveBank
    from skred_tpu_torch.host.timeline import compile_script
    from skred_tpu_torch.parallel.batch import pack_stacked, stack_timelines
    from skred_tpu_torch.tools.card_parity import FOLDERS

    bank = WaveBank()
    for REF in (FOLDERS if dirs is None else dirs):
        REF = pathlib.Path(REF)
        for p in sorted(REF.glob("*.sk")):
            tl = compile_script(p.read_text().splitlines(), seconds,
                                bank=bank, script_dir=REF)
            if tl.fused_passes is None:
                print(f"{p.name:10s} COMPAT (cyclic)")
                continue
            st = pack_stacked(stack_timelines([tl]))
            pp = st.params
            vp = pp["amp"].shape[-1]
            f = []
            if ((pp["freq_mod_osc"] >= 0) & (pp["fm_self"] == 0)).any():
                f.append("fm")
            if (pp["cz_mode"] != 0).any():
                f.append("cz")
            if (pp["amp_mod_osc"] >= 0).any():
                f.append("am")
            if ((pp["pan_mod_osc"] >= 0) & (pp["disconnect"] == 0)).any():
                f.append("pm")
            if (pp["use_amp_envelope"] != 0).any():
                f.append("env")
            if (pp["filter_mode"] != 0).any():
                f.append("flt")
            if (pp["hold_max"] != 0).any():
                f.append("hold")
            if (pp["quantize"] != 0).any():
                f.append("quant")
            if (pp["one_shot"] != 0).any():
                f.append("oneshot")
            if (pp["table_index"] == C.WAVE_TABLE_NOISE_ALT).any():
                f.append("noise")
            if (pp["direction"] != 0).any():
                f.append("dir")
            if ((pp["loop_enabled"] != 0) & (pp["loop_valid"] != 0)).any():
                f.append("loop")
            med = "med_map" in pp
            big = "big_map" in pp
            print(f"{p.name:10s} vp={vp:3d} passes={tl.fused_passes} "
                  f"src={st.n_src} med={int(med)} big={int(big)} "
                  f"segs={pp['amp'].shape[1]:4d}  {','.join(f)}")


if __name__ == "__main__":
    main(float(sys.argv[1]) if len(sys.argv) > 1 else SECONDS)
