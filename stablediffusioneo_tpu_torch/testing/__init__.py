"""Assets of the port that ship with the package: `fixtures`, the seeded
synthetic fixture scenes (the reference's `pictures_croped/bird_*.jpg` role);
`torch_ref_sd3`, the plain fp32 reference of SD 3.5 Medium that the tests
hold `models/sd3.py` to."""
