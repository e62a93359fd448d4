"""Dataset analysis (port of ``mlic_tpu/analysis``): frequency spectra and
band energies, clustering by them, bpp distribution comparison, and a
memoizing cache."""
