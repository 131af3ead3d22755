"""Assets of the port that ship with the package: `fixtures`, the seeded
synthetic fixture scenes (the reference's `pictures_croped/bird_*.jpg` role)."""
