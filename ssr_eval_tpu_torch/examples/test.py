"""Full-option demo (counterpart of reference examples/test.py): every
degradation family enabled.  MP3 requires a host codec (libmp3lame, sox
or ffmpeg); remove setting_mp3_compression when none is installed.

    python -m ssr_eval_tpu_torch.examples.test

reads ./datasets/vctk_test (the helper raises with where to get VCTK when
it is not there) and writes results/ into the working directory."""

from ssr_eval_tpu_torch import BasicTestee, SSR_Eval_Helper


class MyTestee(BasicTestee):
    def __init__(self) -> None:
        super().__init__()

    def infer(self, x):
        """A testee that directly returns the input"""
        return x


def test(device=None):
    testee = MyTestee()
    helper = SSR_Eval_Helper(
        testee,
        test_name="unprocess",
        input_sr=44100,
        output_sr=44100,
        evaluation_sr=44100,
        setting_fft={"cutoff_freq": [12000]},
        setting_lowpass_filtering={
            "filter": ["butter"],
            "cutoff_freq": [12000],
            "filter_order": [6],
        },
        setting_subsampling={"cutoff_freq": [12000]},
        setting_mp3_compression={"low_kbps": [128]},
        save_processed_result=True,
        device=device,
    )
    return helper.evaluate(limit_test_nums=10, limit_test_speaker=-1)


if __name__ == "__main__":
    test()
