// MFEM CPU reference driver for the bioheat implicit-timestep benchmark —
// the exact configuration bench.py runs on the GPU (linear Pennes, theta form,
// H1 order 2, SDIRK33, CG+Jacobi rel_tol 1e-5 max_iter 300), on an
// arbitrary mesh file so the unstructured cardiac tet/hex meshes can be fed
// bit-identically to both sides.
//
// Assembly: PARTIAL for tensor-product elements (hex/quad), FULL (legacy
// SparseMatrix) for simplices — MFEM's DiffusionIntegrator::AssemblePA
// requires DofToQuad::TENSOR maps (fem/integ/bilininteg_diffusion_pa.cpp:123),
// which tets don't have; legacy assembly is the realistic MFEM CPU
// configuration for simplex meshes.
//
// Build (single-core serial MFEM, cmake Release):
//   g++ -O3 -o /tmp/mfem_bioheat_bench tools/mfem_bioheat_bench.cpp \
//       -I/root/reference -I/tmp/mfem-build -L/tmp/mfem-build -lmfem
// Run:
//   /tmp/mfem_bioheat_bench <mesh> [order=2] [steps=5] [dt=0.25] [pa=auto]
#include "mfem.hpp"
#include <chrono>
#include <cstdio>
#include <cmath>
#include <cstring>
using namespace mfem;

static double Lx = 0.04, Ly = 0.04, Lz = 0.02;
static double q_rf(const Vector &x)
{
   // Gaussian SAR source at the electrode tip (mesh/cardiac.py rf_source_q)
   const double cx = Lx / 2, cy = Ly / 2, cz = Lz;
   const double sigma = 0.003, power = 2e7;
   double r2 = (x(0) - cx) * (x(0) - cx) + (x(1) - cy) * (x(1) - cy) +
               (x(2) - cz) * (x(2) - cz);
   return power * std::exp(-r2 / (2.0 * sigma * sigma));
}

class PennesOperator : public TimeDependentOperator
{
public:
   FiniteElementSpace &fes;
   Array<int> ess_tdof;
   BilinearForm M, A;           // rho_c mass;  k diffusion + w_cb mass
   OperatorHandle Mop, Aop, Top;
   std::unique_ptr<Solver> M_prec, T_prec;
   CGSolver M_solver, T_solver;
   std::unique_ptr<Operator> Tc;     // constrained (M + gamma A)
   SparseMatrix *Tmat = nullptr;
   Vector b;                         // (q_rf, v)
   double gamma_cached = -1.0;
   bool pa;
   mutable long cg_iters = 0, solves = 0;

   PennesOperator(FiniteElementSpace &f, bool use_pa)
      : TimeDependentOperator(f.GetTrueVSize()), fes(f), M(&f), A(&f), pa(use_pa)
   {
      Array<int> ess_bdr(f.GetMesh()->bdr_attributes.Max());
      ess_bdr = 1;                                    // theta = 0 everywhere
      f.GetEssentialTrueDofs(ess_bdr, ess_tdof);

      ConstantCoefficient rho_c(3.6e6), k(0.54), w_cb(2e4);
      if (pa) { M.SetAssemblyLevel(AssemblyLevel::PARTIAL); }
      M.AddDomainIntegrator(new MassIntegrator(rho_c));
      M.Assemble();
      if (pa) { A.SetAssemblyLevel(AssemblyLevel::PARTIAL); }
      A.AddDomainIntegrator(new DiffusionIntegrator(k));
      A.AddDomainIntegrator(new MassIntegrator(w_cb));
      A.Assemble();
      if (!pa) { M.Finalize(); A.Finalize(); }

      LinearForm lf(&f);
      FunctionCoefficient src(q_rf);
      lf.AddDomainIntegrator(new DomainLFIntegrator(src));
      lf.Assemble();
      b = lf;

      M.FormSystemMatrix(ess_tdof, Mop);
      if (pa)
      {
         M_prec.reset(new OperatorJacobiSmoother(M, ess_tdof));
      }
      else
      {
         M_prec.reset(new DSmoother(*Mop.As<SparseMatrix>()));
      }
      M_solver.SetOperator(*Mop);
      M_solver.SetPreconditioner(*M_prec);
      M_solver.SetRelTol(1e-5); M_solver.SetMaxIter(300);
   }

   void BuildT(double gamma)
   {
      if (gamma == gamma_cached) { return; }
      gamma_cached = gamma;
      if (pa)
      {
         // matrix-free M + gamma*A with BC elimination
         delete Tmat; Tmat = nullptr;
         auto *sum = new SumOperator(Mop.Ptr(), 1.0, &A, gamma, false, false);
         Tc.reset(new ConstrainedOperator(sum, ess_tdof, true));
         Vector diag_m(height), diag_a(height);
         M.AssembleDiagonal(diag_m);
         A.AssembleDiagonal(diag_a);
         diag_m.Add(gamma, diag_a);
         auto *ja = new OperatorJacobiSmoother(diag_m, ess_tdof);
         T_prec.reset(ja);
      }
      else
      {
         delete Tmat;
         Tmat = Add(1.0, M.SpMat(), gamma, A.SpMat());
         for (int i = 0; i < ess_tdof.Size(); i++)
         {
            Tmat->EliminateRowCol(ess_tdof[i]);
         }
         Tc.reset(new TransposeOperator(new TransposeOperator(Tmat))); // own
         T_prec.reset(new DSmoother(*Tmat));
      }
      T_solver.SetOperator(pa ? *Tc : (Operator &)*Tmat);
      T_solver.SetPreconditioner(*T_prec);
      T_solver.SetRelTol(1e-5); T_solver.SetMaxIter(300);
   }

   void ImplicitSolve(const double gamma, const Vector &u, Vector &k) override
   {
      BuildT(gamma);
      Vector z(height);
      A.Mult(u, z);                 // A theta (PA or SpMat — both fine)
      z.Neg(); z += b;
      for (int i = 0; i < ess_tdof.Size(); i++) { z(ess_tdof[i]) = 0.0; }
      k = 0.0;
      T_solver.Mult(z, k);
      cg_iters += T_solver.GetNumIterations(); solves++;
   }

   void Mult(const Vector &u, Vector &k) const override
   {
      MFEM_ABORT("explicit Mult not used by SDIRK33");
   }
};

int main(int argc, char **argv)
{
   if (argc < 2) { printf("usage: %s mesh [order] [steps] [dt] [pa|fa]\n", argv[0]); return 1; }
   const char *mesh_file = argv[1];
   int order = argc > 2 ? atoi(argv[2]) : 2;
   int steps = argc > 3 ? atoi(argv[3]) : 5;
   double dt = argc > 4 ? atof(argv[4]) : 0.25;

   Mesh mesh(mesh_file, 1, 1);
   bool tensor = (mesh.GetElementGeometry(0) == Geometry::CUBE ||
                  mesh.GetElementGeometry(0) == Geometry::SQUARE);
   bool pa = tensor;
   if (argc > 5) { pa = (strcmp(argv[5], "pa") == 0); }

   H1_FECollection fec(order, mesh.Dimension());
   FiniteElementSpace fes(&mesh, &fec);
   PennesOperator oper(fes, pa);

   std::unique_ptr<ODESolver> ode = ODESolver::Select(23);   // SDIRK33
   ode->Init(oper);

   Vector theta(fes.GetTrueVSize());
   theta = 0.0;
   double t = 0.0;
   ode->Step(theta, t, dt);                                  // warmup/build

   auto t0 = std::chrono::steady_clock::now();
   for (int s = 0; s < steps; s++) { ode->Step(theta, t, dt); }
   auto t1 = std::chrono::steady_clock::now();
   double wall = std::chrono::duration<double>(t1 - t0).count();

   printf("{\"mesh\": \"%s\", \"ne\": %d, \"ndof\": %d, \"order\": %d, "
          "\"assembly\": \"%s\", \"steps\": %d, \"seconds_per_step\": %.6g, "
          "\"dofs_per_s\": %.6g, \"cg_iters_per_solve\": %.2f, "
          "\"theta_max\": %.9g}\n",
          mesh_file, mesh.GetNE(), fes.GetTrueVSize(), order,
          pa ? "partial" : "full", steps, wall / steps,
          fes.GetTrueVSize() * steps / wall,
          oper.solves ? double(oper.cg_iters) / oper.solves : 0.0,
          theta.Max());
   return 0;
}
