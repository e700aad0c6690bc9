"""Train the NVSR mel generator with on-device degradation data
(counterpart of examples/train_nvsr.py).

The reference never trains (lightning is only a Module base there); this
is the framework's native path: HR audio -> random crops -> fft-mask
degradation -> (LR mel, HR mel) pairs -> AdamW steps with periodic
checkpoints, optionally over a ("data", "model") process mesh
(`make_mesh()`: start one process per card, each calling
`parallel.multihost.init_distributed` first).  Swap the synthetic audio
for real 44.1 kHz waveforms for actual training.

    python -m ssr_eval_tpu_torch.examples.train_nvsr
"""

from ssr_eval_tpu_torch.harness.fixtures import speechlike
from ssr_eval_tpu_torch.models.train import NVSRTrainer, make_mesh


def main(steps=200, use_mesh=False, device=None):
    audios = [speechlike(2.0, 44100, seed=s) for s in range(16)]
    mesh = make_mesh(device=device) if use_mesh else None
    trainer = NVSRTrainer(model_name="unet", learning_rate=1e-4, mesh=mesh, device=device)
    state, losses = trainer.fit(
        audios,
        steps=steps,
        batch=8,
        crop_seconds=1.0,
        ckpt_path="./nvsr_generator_ckpt",
        ckpt_every=100,
    )
    print("final loss:", losses[-1])


if __name__ == "__main__":
    main()
