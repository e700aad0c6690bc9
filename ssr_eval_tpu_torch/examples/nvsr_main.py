"""NVSR evaluation demo (counterpart of reference examples/NVSR/main.py):
the 65M UNet generator + voicefixer-structure vocoder through the
batched harness.

With the reference's pretrained torch checkpoint (Zenodo), pass
`ckpt=...` to load the analysis-module weights, and `vocoder_ckpt=...` to
graft a voicefixer-structure vocoder state dict
(models/convert.py::vocoder_state_from_voicefixer); without them, seeded
random weights still exercise the full device pipeline.

    python -m ssr_eval_tpu_torch.examples.nvsr_main
"""

from ssr_eval_tpu_torch import SSR_Eval_Helper
from ssr_eval_tpu_torch.models.testees import NVSRTestee


def main(ckpt=None, vocoder_ckpt=None, testee_cls=NVSRTestee, device=None):
    testee = testee_cls(model_name="unet", ckpt=ckpt, device=device)
    if vocoder_ckpt is not None:
        testee.load_vocoder_checkpoint(vocoder_ckpt)
    helper = SSR_Eval_Helper(
        testee,
        test_name="NVSR",
        input_sr=44100,
        output_sr=44100,
        evaluation_sr=44100,
        # the reference sweep (examples/NVSR/main.py:171): cutoffs in Hz
        setting_fft={"cutoff_freq": [1000, 2000, 4000, 6000, 8000, 12000]},
        save_processed_result=False,
        device=device,
    )
    return helper.evaluate(limit_test_nums=2, limit_test_speaker=-1)


if __name__ == "__main__":
    print(main()["averaged"])
