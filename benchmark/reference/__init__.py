"""The benchmark's plain reference: the ADM UNet and noisy classifier,
FID InceptionV3, respaced schedules with guided DDIM, and the FID's
moments and Frechet distance, in plain PyTorch. It imports nothing of the
program under test, and takes nothing the program made."""
