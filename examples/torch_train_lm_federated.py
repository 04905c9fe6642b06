"""Federated LM training with z-sign compression, checkpoint/restart and
the Plateau sigma schedule, through the PyTorch port's launcher
(``repro_torch.launch.train``).

    PYTHONPATH=src python examples/torch_train_lm_federated.py [--device cpu]

The port of ``examples/train_lm_federated.py``: 60 rounds, then a simulated
crash and a restart to 80 that resumes from the newest checkpoint (round
60: the launcher saves every 25 rounds and at the end). Equivalent CLI:

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2_0_5b \\
        --reduced --rounds 60 --clients 4 --local-steps 2 \\
        --compressor zsign --plateau --ckpt-dir /tmp/zsign_ckpt
"""
import argparse
import subprocess
import sys
import tempfile

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
device = ap.parse_args().device

with tempfile.TemporaryDirectory() as d:
    cmd = [sys.executable, "-m", "repro_torch.launch.train",
           "--arch", "qwen2_0_5b", "--reduced",
           "--rounds", "60", "--clients", "4", "--local-steps", "2",
           "--micro-batch", "2", "--seq-len", "64",
           "--compressor", "zsign", "--sigma", "0.01", "--plateau",
           "--server-lr", "8.0",
           "--participation", "1.0", "--over-provision", "1.25",
           "--ckpt-dir", d, "--save-every", "25", "--device", device]
    print("$", " ".join(cmd))
    subprocess.run(cmd, check=True)
    # simulate a crash + restart: the launcher resumes from the checkpoint
    print("\n--- simulated restart (resumes from newest checkpoint) ---")
    cmd[cmd.index("--rounds") + 1] = "80"
    subprocess.run(cmd, check=True)
