"""The SASS comparer's parsing (cpp_fluid_particles_tpu_torch/exp/
sass_compare.py) on the CPU, on text in ``cuobjdump -sass``'s format: an
entry is compared without its addresses and encodings, and entries fall
into their kernel template by the mangled name. Disassembling a library
needs the CUDA toolkit."""

from cpp_fluid_particles_tpu_torch.exp import sass_compare as sc

PARTICLE = ("_ZN12_GLOBAL__N_120particle_pass_kernelINS_13ViscosityPassELi8"
            "ELb0EEEvPKfS3_PKlPfiiiiiiNS_6ConstsE")
RECORD = ("_ZN12_GLOBAL__N_118record_pass_kernelINS_13ViscosityPassELi8ELb1"
          "ELi1EEEvNS_7RecordsIT_EEPKlPfiiiiiiNS_6ConstsE")


def _dump(particle_ins, record_ins, base=0):
    """Two entries as cuobjdump prints them, at addresses from ``base``."""
    lines = ["\tcode for sm_90a"]
    for name, body in ((PARTICLE, particle_ins), (RECORD, record_ins)):
        lines += [f"\t\tFunction : {name}",
                  '\t.headerflags\t@"EF_CUDA_SM90"']
        for n, ins in enumerate(body):
            lines += [f"        /*{base + 16 * n:04x}*/                   "
                      f"{ins} ;   /* 0x{n:016x} */",
                      f"                                 /* 0x{base:016x} */"]
        lines.append("\t\t..........")
    return "\n".join(lines)


def test_entries_drop_addresses_and_encodings():
    got = sc.entries(_dump(["LDC R1, c[0x0][0x28]", "EXIT"], ["EXIT"]))
    assert set(got) == {PARTICLE, RECORD}
    assert "LDC R1, c[0x0][0x28] ;" in got[PARTICLE]
    assert "0x" not in got[RECORD].replace("c[0x0]", "")
    moved = sc.entries(_dump(["LDC R1, c[0x0][0x28]", "EXIT"], ["EXIT"],
                             base=0x100))
    assert moved == got


def test_entries_cut_the_namespace_hash_of_a_build():
    """nvcc tags the anonymous namespace with a hash that differs between
    two builds of one source: an entry is matched and compared without
    it."""
    def tagged(h):
        return _dump(["LDC R1, c[0x0][0x28]", "EXIT"], ["EXIT"]).replace(
            "_ZN12_GLOBAL__N_1", f"_ZN47_GLOBAL__N__{h}_14_column_pass_cu_"
            "c34a53fb")
    a, b = sc.entries(tagged("6d5d6662")), sc.entries(tagged("6f93a8a7"))
    assert a == b and len(a) == 2
    assert all("6d5d6662" not in name for name in a)


def test_compare_sorts_entries_by_kernel_and_outcome():
    old = sc.entries(_dump(["LDC R1, c[0x0][0x28]", "EXIT"], ["EXIT"]))
    new = sc.entries(_dump(["LDC R1, c[0x0][0x28]", "EXIT"],
                           ["NOP", "EXIT"]))
    new["_ZN12_GLOBAL__N_111pack_kernelINS_13ViscosityPassEEEvv"] = "EXIT ;"
    report = sc.compare(old, new)
    assert report["particle_pass_kernel"]["same"] == [PARTICLE]
    assert report["record_pass_kernel"]["changed"] == [RECORD]
    assert report["pack_kernel"]["only_new"] == [
        "_ZN12_GLOBAL__N_111pack_kernelINS_13ViscosityPassEEEvv"]
    assert not any(r["only_old"] for r in report.values())


def test_kernel_of_tells_the_counted_kernels_apart():
    """The counted walk and its position pack fall into templates of their
    own, apart from the record kernel and pack_kernel whose names they
    resemble."""
    walk = ("_ZN12_GLOBAL__N_119counted_pass_kernelINS_13PbdLambdaPassELi8"
            "ELb0ELi2EEEvNS_7CountedEPKlPfiiiiiiNS_6ConstsE")
    pack = ("_ZN12_GLOBAL__N_117count_pack_kernelEPKfS1_P6float4PiS3_S4_ii"
            "lNS_6ConstsE")
    assert sc.kernel_of(walk) == "counted_pass_kernel"
    assert sc.kernel_of(pack) == "count_pack_kernel"
    assert sc.kernel_of(RECORD) == "record_pass_kernel"
